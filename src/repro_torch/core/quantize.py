"""Affine quantization — the paper's in-cache 8-bit pipeline (§IV-D).

After each layer Neural Cache (1) reduces min/max over every output element
in-cache, (2) ships the two scalars to the CPU, which computes a fixed-point
multiplier and a zero point, and (3) requantizes every element in-cache with
integer multiply/add/shift.  This module is the CPU-side scalar step and the
integer requantization, bit-exact with ``repro.core.quantize``: every scalar
is computed in float32 with round-half-even (``torch.round``), on the CPU.
The tensor functions (``quantize``, ``dequantize``, ``fake_quant``,
``quantize_per_channel``) run on the tensor's device, in float32 with
round-half-even, and give the reference's bytes.

``QuantParams.scale`` is a Python float holding a float32 value and
``zero_point`` a Python int, so host code can use them directly.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "QuantParams",
    "f32",
    "choose_qparams",
    "choose_qparams_symmetric",
    "quantize",
    "dequantize",
    "fake_quant",
    "quantize_per_channel",
    "fixed_point_multiplier",
    "choose_qparams_rows",
    "fixed_point_multiplier_rows",
    "requantize_fixedpoint",
    "requantize_reference",
]


def f32(x) -> float:
    """Round a Python number to the nearest float32 value."""
    return float(torch.tensor(float(x), dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Affine (asymmetric) quantization: real = scale * (q - zero_point)."""

    scale: float
    zero_point: int
    bits: int = 8
    signed: bool = False

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1)) if self.signed else 0

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1 if self.signed else (1 << self.bits) - 1


def choose_qparams(x_min, x_max, bits: int = 8,
                   signed: bool = False) -> QuantParams:
    """min/max -> (scale, zero_point), TF-Lite/gemmlowp convention: the range
    always includes 0 so that zero is exactly representable.  ``x_min`` and
    ``x_max`` are taken as float32."""
    lo = torch.minimum(torch.tensor(float(x_min), dtype=torch.float32),
                       torch.tensor(0.0))
    hi = torch.maximum(torch.tensor(float(x_max), dtype=torch.float32),
                       torch.tensor(0.0))
    qmin = -(1 << (bits - 1)) if signed else 0
    qmax = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    scale = (hi - lo) / (qmax - qmin)
    scale = torch.where(scale <= 0, torch.tensor(1.0), scale)
    zp = torch.clamp(torch.round(qmin - lo / scale), qmin, qmax)
    return QuantParams(scale=float(scale), zero_point=int(zp), bits=bits,
                       signed=signed)


def choose_qparams_symmetric(x_absmax, bits: int = 8) -> QuantParams:
    """Symmetric signed quantization (zero_point = 0), the W8A8 kernel's
    activation convention; ``x_absmax`` is taken as float32."""
    qmax = (1 << (bits - 1)) - 1
    amax = torch.tensor(float(x_absmax), dtype=torch.float32)
    scale = torch.clamp_min(amax, 1e-12) / qmax
    return QuantParams(scale=float(scale), zero_point=0, bits=bits,
                       signed=True)


def _scale_t(qp: QuantParams, device) -> torch.Tensor:
    return torch.tensor(qp.scale, dtype=torch.float32, device=device)


def quantize(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """``clip(round(x / scale) + zero_point)`` in float32, as int8 (signed)
    or uint8."""
    q = torch.round(x.to(torch.float32) / _scale_t(qp, x.device))
    q = torch.clamp(q + qp.zero_point, qp.qmin, qp.qmax)
    return q.to(torch.int8 if qp.signed else torch.uint8)


def dequantize(q: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    return (q.to(torch.float32) - qp.zero_point) * _scale_t(qp, q.device)


def fake_quant(x: torch.Tensor, bits: int = 8,
               signed: bool = False) -> torch.Tensor:
    """Quantize-dequantize round trip (per-tensor, dynamic min/max)."""
    qp = choose_qparams(x.min(), x.max(), bits=bits, signed=signed)
    return dequantize(quantize(x, qp), qp)


def quantize_per_channel(w: torch.Tensor, axis: int = -1, bits: int = 8):
    """Symmetric per-channel weight quantization: ``(int8 weights, float32
    scales broadcastable against w)``, the scales reduced over every axis
    but ``axis``.  A stacked ``[L, K, N]`` leaf with ``axis=-1`` thus gets
    one scale per output channel shared by all L layers (shape
    ``[1, 1, N]``), as in the reference.

    Leaves of three or more dimensions are quantized one slice of the
    leading axis at a time (the max over slices is the same number), so no
    float32 copy of the whole leaf is made."""
    axis %= w.ndim
    qmax = (1 << (bits - 1)) - 1
    sliced = w.ndim >= 3 and axis != 0
    if sliced:
        inner = [d - 1 for d in range(1, w.ndim) if d != axis]
        amax = torch.stack([w[i].to(torch.float32).abs().amax(dim=inner,
                                                             keepdim=True)
                            for i in range(w.shape[0])]).amax(0, keepdim=True)
    else:
        amax = w.to(torch.float32).abs().amax(
            dim=[d for d in range(w.ndim) if d != axis], keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))

    def q_of(wf, s):
        return torch.clamp(torch.round(wf / s), -qmax - 1, qmax).to(torch.int8)

    if sliced:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        for i in range(w.shape[0]):
            q[i] = q_of(w[i].to(torch.float32), scale[0])
    else:
        q = q_of(w.to(torch.float32), scale)
    return q, scale


def fixed_point_multiplier(real_multiplier, bits: int = 31) -> tuple[int, int]:
    """Decompose a positive real multiplier into ``(mantissa, right shift)``
    with ``real = m * 2^-s`` and ``m`` in ``[2^30, 2^31)`` (gemmlowp's
    ``QuantizeMultiplierSmallerThanOne``), in float32 like the reference."""
    x = torch.tensor(float(real_multiplier), dtype=torch.float32)
    # XLA evaluates float32 log2 as log(x) * (1/ln 2), which lands an ulp
    # off an exact integer at some powers of two (2^-31 gives -30.999998);
    # the ceiling then flips, so the reference's formula is kept here
    exp = math.ceil(float(torch.log(x) * torch.tensor(1.0 / math.log(2.0),
                                                      dtype=torch.float32)))
    shift = -exp + bits
    m = torch.round(x * torch.pow(torch.tensor(2.0), torch.tensor(
        float(shift), dtype=torch.float32)))
    # the float32 clamp bound rounds up to 2^bits; the reference's integer
    # conversion (JAX's default 32-bit mode) then saturates at 2^31 - 1, so
    # an exact power of two yields 2^bits - 1 as there
    m = torch.clamp(m, 0, (1 << bits) - 1)
    return min(int(m), (1 << bits) - 1), shift


def choose_qparams_rows(x_min: torch.Tensor, x_max: torch.Tensor,
                        bits: int = 8, signed: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`choose_qparams` of each row: float32 ``[B]`` ranges to
    ``(scale, zero_point)``, float32 and int64 ``[B]``, on the CPU.  The
    same IEEE float32 operations element by element, so each row's values
    are bit for bit those of the scalar call on ``(x_min[b], x_max[b])``."""
    lo = x_min.to(torch.float32)
    lo = torch.minimum(lo, torch.zeros_like(lo))
    hi = x_max.to(torch.float32)
    hi = torch.maximum(hi, torch.zeros_like(hi))
    qmin = -(1 << (bits - 1)) if signed else 0
    qmax = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    scale = (hi - lo) / (qmax - qmin)
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(qmin - lo / scale), qmin, qmax)
    return scale, zp.to(torch.int64)


# a mantissa within this (relative) of a power of two puts log2 within
# about 2^-12 of an integer, where the float32 log formula of
# fixed_point_multiplier may land either side (its error is below 1e-5)
_NEAR_POW2 = 2.0 ** -11


def fixed_point_multiplier_rows(real_multiplier: torch.Tensor,
                                bits: int = 31
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fixed_point_multiplier` of each element of a float32 ``[B]``
    CPU tensor: ``(mantissa, shift)``, int64 ``[B]``, equal to the scalar
    call on each element.  The exponent comes exactly from ``frexp``; where
    ``log2`` lies within about 2^-12 of an integer, so that the scalar
    call's float32 log may round across the ceiling, or the value is not a
    positive finite number, the scalar call itself decides."""
    x = real_multiplier.to(torch.float32)
    frac, exp = torch.frexp(x)  # x = frac * 2^exp, frac in [0.5, 1)
    shift = bits - exp.to(torch.int64)
    m = torch.round(torch.ldexp(x.to(torch.float64), shift.to(torch.float64)))
    m = torch.clamp(m, 0, (1 << bits) - 1).to(torch.int64)
    near = ((frac < 0.5 * (1 + _NEAR_POW2)) | (frac > 1 - _NEAR_POW2 / 2)
            | ~(x > 0) | ~torch.isfinite(x))
    for i in torch.nonzero(near).flatten().tolist():
        m[i], shift[i] = fixed_point_multiplier(float(x[i]), bits)
    return m, shift


def requantize_fixedpoint(acc: torch.Tensor, multiplier: int, shift: int,
                          zero_point: int = 0, qmin: int = 0,
                          qmax: int = 255) -> torch.Tensor:
    """Integer accumulator -> n-bit output with integer multiply and
    round-shift: ``out = (acc * m + 2^(s-1)) >> s``, in int64, clipped and
    returned as int32."""
    acc = acc.to(torch.int64)
    rounded = (acc * int(multiplier) + (1 << (int(shift) - 1))) >> int(shift)
    return torch.clamp(rounded + int(zero_point), qmin, qmax).to(torch.int32)


def requantize_reference(acc: torch.Tensor, real_multiplier,
                         zero_point: int = 0, qmin: int = 0,
                         qmax: int = 255) -> torch.Tensor:
    """Float reference for :func:`requantize_fixedpoint`: ``round(f32(acc) *
    f32(real_multiplier)) + zero_point`` (round-half-even), clipped, as
    int32."""
    m = torch.tensor(float(real_multiplier), dtype=torch.float32,
                     device=acc.device)
    out = torch.round(acc.to(torch.float32) * m) + int(zero_point)
    return torch.clamp(out, qmin, qmax).to(torch.int32)
