"""The §IV-D requantization of a whole batch: the hand-written Hopper
kernel and its plain version.

    y = clamp(((x[b, p, c] - in_zp[b]) * mult[b] + 2^(shift[b]-1))
              >> shift[b] + out_zp[b], 0, 255)
    out[b, p, offset + c] = y (uint8),  live[b] = #{(p, c): y != out_zp[b]}

in int64 with an arithmetic shift.  ``x`` is ``[B, P, C]``, a
convolution's int64 staging or a branch's uint8 activations; ``out`` is
uint8 ``[B, P, Ctot]`` and takes the values at channels ``offset`` to
``offset + C - 1``, so that a concatenation writes each branch into its
slice of the block's output.  The parameters are one integer per row
(``[B]`` sequences or CPU tensors, or one number for every row); ``shift``
is 1..63, as the per-image ``(acc * m + 2^(s-1)) >> s`` needs.

:func:`requant_rows` launches ``src/repro_torch/csrc/requant_rows.cu`` for
CUDA tensors (and adds one to ``requant_rows.launches``): the parameters
reach the card in one copy from pinned memory, which does not wait for the
card, and the kernel reads each value once and writes it once, with the
live counts, when asked, in the same launch.  It never falls back on a
CUDA tensor: a kernel that does not build, or a launch that fails, raises
:class:`~repro_torch.kernels.cuda_build.KernelError`.  CPU tensors take
the plain version, :func:`requant_rows_plain`, the same formula in torch
over ``[B, 1, 1]`` parameters.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build as _cb
from repro_torch.kernels.bitserial_matmul import CARD_SMS

__all__ = ["requant_rows", "requant_rows_plain", "requant_blocks"]

REQUANT_TARGET_BLOCKS = 8 * CARD_SMS  # 8 blocks of 256 threads fill an SM
REQUANT_THREADS = 256


def requant_blocks(B: int, n: int) -> int:
    """Blocks a row: enough that ``B`` rows fill the card, no more than
    leaves each thread one group of 8 values of the row's ``n``."""
    want = -(-REQUANT_TARGET_BLOCKS // max(B, 1))
    return max(1, min(want, -(-n // (8 * REQUANT_THREADS))))


def _params(B: int, in_zp, mult, shift, out_zp,
            pin: bool = False) -> torch.Tensor:
    """int64 ``[5, B]`` on the CPU: the four parameter rows and a zero row
    for the live counts."""
    p = torch.zeros((5, B), dtype=torch.int64, pin_memory=pin)
    for i, v in enumerate((in_zp, mult, shift, out_zp)):
        p[i] = torch.as_tensor(v, dtype=torch.int64)
    if B and not bool(((p[2] >= 1) & (p[2] <= 63)).all()):
        raise ValueError(f"shift must be in 1..63, got {p[2].tolist()}")
    return p


def _check(x: torch.Tensor, out: torch.Tensor, offset: int) -> None:
    if x.ndim != 3 or x.dtype not in (torch.int64, torch.uint8):
        raise ValueError(f"x must be a [B, P, C] int64 or uint8 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if (out.ndim != 3 or out.dtype != torch.uint8
            or out.shape[:2] != x.shape[:2]):
        raise ValueError(f"out must be uint8 [B, P, Ctot] beside x "
                         f"{tuple(x.shape)}, got {tuple(out.shape)} "
                         f"{out.dtype}")
    if not 0 <= offset <= out.shape[2] - x.shape[2]:
        raise ValueError(f"channels {offset}..{offset + x.shape[2] - 1} lie "
                         f"outside out's {out.shape[2]}")


def requant_rows_plain(x: torch.Tensor, out: torch.Tensor, in_zp, mult,
                       shift, out_zp, offset: int = 0,
                       live: bool = False) -> torch.Tensor | None:
    """The same function as :func:`requant_rows` in torch on ``x``'s
    device; returns the live counts, int64 ``[B]``, when ``live``."""
    _check(x, out, offset)
    B, C = x.shape[0], x.shape[2]
    p = _params(B, in_zp, mult, shift, out_zp)[:4].to(x.device)
    in_zp, mult, shift, out_zp = p.reshape(4, B, 1, 1)
    rounded = ((x.to(torch.int64) - in_zp) * mult
               + torch.bitwise_left_shift(torch.ones_like(shift),
                                          shift - 1)) >> shift
    y = torch.clamp(rounded + out_zp, 0, 255).to(torch.uint8)
    out[:, :, offset:offset + C] = y
    return (y != out_zp).sum((1, 2)) if live else None


def requant_rows(x: torch.Tensor, out: torch.Tensor, in_zp, mult, shift,
                 out_zp, offset: int = 0,
                 live: bool = False) -> torch.Tensor | None:
    """Requantize ``x`` into ``out``'s channels from ``offset`` (see the
    module docstring); the live counts, int64 ``[B]`` on ``x``'s device,
    when ``live``.  CUDA tensors launch the Hopper kernel (one count, one
    launch); CPU tensors run :func:`requant_rows_plain`."""
    if x.device.type == "cpu":
        return requant_rows_plain(x, out, in_zp, mult, shift, out_zp,
                                  offset, live)
    _check(x, out, offset)
    dev = x.device
    _cb.check_operands([("x", x), ("out", out)], dev)
    B, P, C = x.shape
    Ctot = out.shape[2]
    if B > 65535 or P * max(C, Ctot) >= 1 << 31:
        raise ValueError(f"shape {tuple(x.shape)} -> {Ctot} channels "
                         f"exceeds the launch range")
    params = _params(B, in_zp, mult, shift, out_zp, pin=True).to(
        dev, non_blocking=True)
    if B == 0 or P == 0 or C == 0:
        return params[4] if live else None
    lib = _cb.build("requant_rows")
    with torch.cuda.device(dev):
        err = lib.requant_rows(
            x.data_ptr(), int(x.dtype == torch.uint8), out.data_ptr(),
            params.data_ptr(), B, P, C, Ctot, offset,
            requant_blocks(B, P * C), int(live), _cb.launch_stream(dev))
    _cb.raise_on_error(err, "requant_rows")
    requant_rows.launches += 1
    return params[4] if live else None


requant_rows.launches = 0
