"""Post-training quantization of the LM (the port of ``repro.quant``)."""
from repro_torch.quant.ptq import (
    CalibrationStats, calibrate, quantize_lm_params, QuantizedLinear,
    quantized_matmul, bitserial_linear,
)

__all__ = ["CalibrationStats", "calibrate", "quantize_lm_params",
           "QuantizedLinear", "quantized_matmul", "bitserial_linear"]
