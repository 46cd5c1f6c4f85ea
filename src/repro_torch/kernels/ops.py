"""Entry points the engine calls into the kernels.

:func:`bitserial_matmul_exact` is the exact unsigned bit-serial GEMM the
``gemm`` backend (core/backends.py) runs: the 8-bit kernel, or the W4A4
kernel on nibble-packed activations.  :func:`quant_matmul` is the W8A8 GEMM
of the post-training-quantization flow (``quant/ptq.py``) and
:func:`flash_attention` the tiled attention of the LM's full prefill
(``models/layers.py``).  Each launches its Hopper kernel for CUDA tensors
and runs the kernel's plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitserial_matmul as _bsm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quant_matmul as _qm

__all__ = ["bitserial_matmul_exact", "quant_matmul", "flash_attention",
           "pack_weights"]


def bitserial_matmul_exact(x_q: torch.Tensor, planes: torch.Tensor, *,
                           n_bits: int, w4a4: bool = False) -> torch.Tensor:
    """Exact unsigned-integer bit-serial GEMM ``[M, K] x [K, N] -> [M, N]``
    int32: unsigned plane weights (the MSB carries +2^(n-1), the packed word
    engine's operand convention) and the accumulator returned verbatim.
    ``w4a4=True`` takes nibble-packed activations ``[M, ceil(K/2)]``
    (:func:`~repro_torch.kernels.bitserial_matmul.pack_activation_nibbles`)
    through the W4A4 kernel, with unsigned nibbles."""
    if w4a4:
        return _bsm.bitserial_matmul_a4(x_q, planes, 1.0, None, n_bits=n_bits,
                                        out_dtype=torch.int32, signed=False)
    return _bsm.bitserial_matmul(x_q, planes, 1.0, None, n_bits=n_bits,
                                 out_dtype=torch.int32, signed=False)


def pack_weights(w_q: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Weight-load-time transpose to the byte-packed bit-plane layout: bit
    ``b`` of each uint8 is plane ``b`` of the two's complement over
    ``n_bits`` (``repro.kernels.ref.pack_bitplanes_bytes``)."""
    if not 1 <= n_bits <= 8:
        raise ValueError(f"n_bits must be in 1..8, got {n_bits}")
    return (w_q.to(torch.int64) & ((1 << n_bits) - 1)).to(torch.uint8)


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale,
                 w_scale: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """W8A8 GEMM with the fused dequantization epilogue
    (:mod:`repro_torch.kernels.quant_matmul`)."""
    return _qm.quant_matmul(x_q, w_q, x_scale, w_scale, bias)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Tiled GQA attention with an online softmax
    (:mod:`repro_torch.kernels.flash_attention`)."""
    return _fa.flash_attention(q, k, v, causal=causal)
