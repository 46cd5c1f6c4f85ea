"""Post-training quantization (the port of ``repro.quant.ptq``).

Neural Cache's execution model is: all layer I/O is 8-bit, weights are
8-bit stationary in the arrays, partial sums are wide, and each layer's
outputs are requantized from layer-wise min/max.  On the GPU this becomes:

  * weights: per-channel symmetric int8 (scales absorbed into the epilogue),
  * activations: per-tensor affine uint8 from calibration min/max,
    re-centred to int8 for the kernel,
  * GEMM: int8 x int8 -> int32 with the dequantization epilogue fused
    (:func:`repro_torch.kernels.ops.quant_matmul`, the hand-written W8A8
    kernel),
  * sub-8-bit weights: byte-packed bit planes through the bit-serial GEMM
    (:func:`repro_torch.kernels.bitserial_matmul.bitserial_matmul`), whose
    cost scales with the number of planes.

``calibrate`` runs the float model over sample batches collecting per-site
min/max; ``quantize_lm_params`` converts an LM parameter tree;
``QuantizedLinear`` / ``quantized_matmul`` are the serving-path ops.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.quantize import (QuantParams, choose_qparams, quantize,
                                       quantize_per_channel)
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels import bitserial_matmul as _bsm
from repro_torch.kernels import ops as K

__all__ = [
    "CalibrationStats", "calibrate", "quantize_lm_params",
    "QuantizedLinear", "quantized_matmul", "bitserial_linear",
]

_F32 = torch.float32


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CalibrationStats:
    """Running min/max per named site (EMA like TF-Lite's calibrator), as
    float32 scalars on the observed tensors' device."""

    momentum: float = 0.9
    mins: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    maxs: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def observe(self, name: str, x: torch.Tensor) -> None:
        mn = torch.min(x).to(_F32)
        mx = torch.max(x).to(_F32)
        if name in self.mins:
            m = torch.tensor(self.momentum, dtype=_F32, device=mn.device)
            m1 = torch.tensor(1 - self.momentum, dtype=_F32, device=mn.device)
            self.mins[name] = m * self.mins[name] + m1 * mn
            self.maxs[name] = m * self.maxs[name] + m1 * mx
        else:
            self.mins[name] = mn
            self.maxs[name] = mx

    def qparams(self, name: str, bits: int = 8) -> QuantParams:
        return choose_qparams(self.mins[name], self.maxs[name], bits=bits)


def calibrate(apply_fn: Callable[..., Any], batches, stats: CalibrationStats,
              observe_sites: Callable[[CalibrationStats, Any, Any], None]):
    """Run ``apply_fn`` over ``batches``; the caller's ``observe_sites``
    records the tensors it cares about.  Returns the stats (mutated)."""
    for batch in batches:
        out = apply_fn(batch)
        observe_sites(stats, batch, out)
    return stats


# ---------------------------------------------------------------------------
# weight conversion
# ---------------------------------------------------------------------------
def _is_linear_leaf(path: str, x) -> bool:
    name = path.rsplit("/", 1)[-1]
    return (isinstance(x, torch.Tensor) and x.ndim >= 2
            and name in ("wq", "wk", "wv", "wo", "wi", "wg", "embed", "head",
                         "in_proj", "out_proj"))


def quantize_lm_params(params: Any, bits: int = 8,
                       skip: tuple[str, ...] = ("embed",)) -> Any:
    """Convert matmul weights to ``{'q': int8, 'scale': float32
    per-channel}`` (a new tree; other leaves are the same tensors).

    Norms and biases stay float.  A 2-D weight's scale is ``[N]``; a
    stacked ``[L, K, N]`` leaf keeps the reference's ``[1, 1, N]`` scale,
    shared by its L layers.  ``bits < 8`` also stores the byte-packed
    planes (bit b of each byte is plane b) and ``plane_bits``.
    """

    def leaf(path: str, x):
        name = path.rsplit("/", 1)[-1]
        if not _is_linear_leaf(path, x) or name in skip:
            return x
        q, scale = quantize_per_channel(x, axis=-1, bits=bits)
        if x.ndim == 2:  # kernel convention: w_scale is [N]
            scale = scale.reshape(-1)
        out = {"q": q, "scale": scale.to(_F32)}
        if bits < 8:
            out["planes"] = K.pack_weights(q, bits)
            out["plane_bits"] = bits
        return out

    def walk(path: str, x):
        if isinstance(x, dict):
            return {k: walk(f"{path}/{k}" if path else str(k), v)
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(f"{path}/{i}" if path else str(i), v)
                    for i, v in enumerate(x)]
        return leaf(path, x)

    return walk("", params)


# ---------------------------------------------------------------------------
# serving-path ops
# ---------------------------------------------------------------------------
def quantized_matmul(x: torch.Tensor, wq: dict,
                     x_qp: QuantParams | None = None) -> torch.Tensor:
    """x (float) @ quantized weight -> float.

    With ``x_qp`` the activation is quantized to int8 first and the GEMM
    runs W8A8 through the fused kernel; without it the weight is
    dequantized on the fly (weight-only quantization).  A DTensor ``x``
    (a step sharded over a mesh) runs through ``local_map``: each rank
    multiplies its own rows by the whole weight (the kernel on its local
    shard), and the product keeps x's row split; rows are independent, so
    this is exact.
    """
    if is_dtensor(x):
        return _local_rows(x, wq, x_qp)
    if x_qp is None:
        w = wq["q"].to(x.dtype) * wq["scale"].to(x.dtype)
        return x @ w
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq, zp = _to_int8(quantize(x2, x_qp), x_qp)
    y = K.quant_matmul(xq, wq["q"], x_qp.scale, wq["scale"])
    # exact affine correction: x = s*(q - zp)  =>
    # x @ W = s*sw*(q @ qw) - s*zp*sw*colsum(qw)
    y = y + _zp_correction(wq, x_qp.scale, zp)
    return y.reshape(*lead, -1).to(x.dtype)



def _local_rows(x, wq: dict, x_qp: QuantParams | None):
    """:func:`quantized_matmul` of a DTensor ``x`` [..., K] on each rank's
    rows: a mesh dim splitting a leading dim keeps it, every other mesh
    dim (a split of K) is gathered; the weight and its scale are whole on
    every rank."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    x_pl = [p if p.is_shard() and p.dim < x.ndim - 1 else Replicate()
            for p in x.placements]
    w_pl = [Replicate()] * len(x_pl)
    names = sorted(wq)
    ws = [wq[n] for n in names]

    def local(xl, *wl):
        return quantized_matmul(xl, dict(zip(names, wl)), x_qp)

    return local_map(local, out_placements=x_pl,
                     in_placements=(x_pl,) + tuple(
                         w_pl if torch.is_tensor(w) else None for w in ws),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, *ws)


def _to_int8(q: torch.Tensor, x_qp: QuantParams):
    """uint8 [0,255] -> int8 [-128,127] by re-centering (the kernels are
    int8); the shifted zero point keeps the affine math exact."""
    if x_qp.signed:
        return q.to(torch.int8), x_qp.zero_point
    return (q.to(torch.int32) - 128).to(torch.int8), x_qp.zero_point - 128


def _zp_correction(wq: dict, scale: float, zp: int) -> torch.Tensor:
    colsum = torch.sum(wq["q"].to(torch.int64), dim=0).to(_F32)
    s = torch.tensor(scale, dtype=_F32, device=colsum.device) * zp
    return -s * colsum * wq["scale"].reshape(-1)


def bitserial_linear(x: torch.Tensor, wq: dict,
                     x_qp: QuantParams) -> torch.Tensor:
    """Sub-8-bit path: plane-decomposed GEMM (precision-proportional cost),
    signed planes and the float32 epilogue of the bit-serial kernel."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq, zp = _to_int8(quantize(x2, x_qp), x_qp)
    y = _bsm.bitserial_matmul(xq, wq["planes"], x_qp.scale,
                              wq["scale"].reshape(-1),
                              n_bits=int(wq.get("plane_bits", 8)),
                              out_dtype=_F32, signed=True)
    y = y + _zp_correction(wq, x_qp.scale, zp)
    return y.reshape(*lead, -1).to(x.dtype)


@dataclasses.dataclass
class QuantizedLinear:
    """A linear layer bound to its calibrated activation qparams."""

    wq: dict
    x_qp: QuantParams | None = None
    bits: int = 8

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits < 8 and "planes" in self.wq and self.x_qp is not None:
            return bitserial_linear(x, self.wq, self.x_qp)
        return quantized_matmul(x, self.wq, self.x_qp)
