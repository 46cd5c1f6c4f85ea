"""Per-row min and max of the §IV-D dynamic-range tree: the hand-written
Hopper kernel and its plain version.

    u = (x[r, k] + bias) & (2^bits - 1),  bias = 2^(bits-1) if signed else 0
    mins[r] = min_k u - bias,  maxs[r] = max_k u - bias   (u unsigned)

``x`` is ``[rows, K]`` int64 with ``K >= 1``; ``bits`` is 1..63.  For
``bits``-wide two's complement values this is their signed (``signed``) or
unsigned min and max; ``bits=32, signed=True`` is the int32 min and max of
the low words.

:func:`minmax_rows` launches ``src/repro_torch/csrc/minmax_rows.cu`` for
CUDA tensors (and adds one to ``minmax_rows.launches``), which reads each
value once.  The kernel cuts each row into :func:`minmax_chunks` ranges,
one block each, and where there is more than one a second launch combines
the blocks' partial results from a workspace the wrapper allocates.  It
never falls back on a CUDA tensor: a kernel that does not build, or a
launch that fails, raises
:class:`~repro_torch.kernels.cuda_build.KernelError`.  CPU tensors take
the plain version, :func:`minmax_rows_plain`: the engine's bit-serial walk
of the in-cache tree (``core.nc_layers.minmax_walk``), which stays engine
code and is reached only when called, as ``core.backends`` reaches the
kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build as _cb
from repro_torch.kernels.bitserial_matmul import CARD_SMS

__all__ = ["minmax_rows", "minmax_rows_plain", "minmax_chunks"]

MINMAX_TARGET_BLOCKS = 8 * CARD_SMS  # 8 blocks of 256 threads fill an SM
MINMAX_MIN_CHUNK = 2048  # int64 values a block reads at the least


def minmax_chunks(rows: int, K: int) -> int:
    """Blocks per row: enough that ``rows * chunks`` fills the card, no more
    than leaves each block :data:`MINMAX_MIN_CHUNK` values."""
    want = -(-MINMAX_TARGET_BLOCKS // max(rows, 1))
    return max(1, min(want, -(-K // MINMAX_MIN_CHUNK)))


def _check(x: torch.Tensor, bits: int) -> None:
    if x.ndim != 2 or x.dtype != torch.int64:
        raise ValueError(f"x must be a 2-D int64 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[1] < 1:
        raise ValueError("rows must hold at least one value")
    if not 1 <= bits <= 63:
        raise ValueError(f"bits must be in 1..63, got {bits}")


def minmax_rows_plain(x: torch.Tensor, bits: int,
                      signed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function as :func:`minmax_rows` by the engine's bit-serial
    walk, on ``x``'s device."""
    from repro_torch.core.nc_layers import minmax_walk

    _check(x, bits)
    return minmax_walk(x, bits, signed)


def minmax_rows(x: torch.Tensor, bits: int,
                signed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mins, maxs)``, int64 ``[rows]`` (see the module docstring).  CUDA
    tensors launch the Hopper kernel (one count, one or two launches); CPU
    tensors run :func:`minmax_rows_plain`."""
    if x.device.type == "cpu":
        return minmax_rows_plain(x, bits, signed)
    _check(x, bits)
    dev = x.device
    _cb.check_operands([("x", x)], dev)
    rows, K = x.shape
    mins = torch.empty(rows, dtype=torch.int64, device=dev)
    maxs = torch.empty(rows, dtype=torch.int64, device=dev)
    if rows == 0:
        return mins, maxs
    chunks = minmax_chunks(rows, K)
    if K >= 1 << 31 or rows * chunks >= 1 << 31:
        raise ValueError(f"shape {(rows, K)} exceeds the launch range")
    workspace = (torch.empty(2 * rows * chunks, dtype=torch.int64,
                             device=dev) if chunks > 1 else None)
    lib = _cb.build("minmax_rows")
    with torch.cuda.device(dev):
        err = lib.minmax_rows(
            x.data_ptr(), mins.data_ptr(), maxs.data_ptr(),
            workspace.data_ptr() if workspace is not None else None,
            rows, K, chunks, bits, int(signed), _cb.launch_stream(dev))
    _cb.raise_on_error(err, "minmax_rows")
    minmax_rows.launches += 1
    return mins, maxs


minmax_rows.launches = 0
