"""Affine quantization — the paper's in-cache 8-bit pipeline (§IV-D).

After each layer Neural Cache (1) reduces min/max over every output element
in-cache, (2) ships the two scalars to the CPU, which computes a fixed-point
multiplier and a zero point, and (3) requantizes every element in-cache with
integer multiply/add/shift.  This module is the CPU-side scalar step and the
integer requantization, bit-exact with ``repro.core.quantize``: every scalar
is computed in float32 with round-half-even (``torch.round``), on the CPU.

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
    "fixed_point_multiplier",
    "requantize_fixedpoint",
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


def requantize_fixedpoint(acc: torch.Tensor, multiplier: int, shift: int,
                          zero_point: int = 0, qmin: int = 0,
                          qmax: int = 255) -> torch.Tensor:
    """Integer accumulator -> n-bit output with integer multiply and
    round-shift: ``out = (acc * m + 2^(s-1)) >> s``, in int64, clipped and
    returned as int32."""
    acc = acc.to(torch.int64)
    rounded = (acc * int(multiplier) + (1 << (int(shift) - 1))) >> int(shift)
    return torch.clamp(rounded + int(zero_point), qmin, qmax).to(torch.int32)
