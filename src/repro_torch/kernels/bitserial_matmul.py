"""Bit-serial GEMMs: the hand-written Hopper kernels and their plain
versions.

    out = sum_b pw[b] * (x @ plane_b),  pw[b] = 2^b  (MSB: -2^(n-1) if signed)

``planes`` is the byte-packed ``[K, N]`` uint8 format (bit ``b`` of each byte
is plane ``b``).  :func:`bitserial_matmul` takes 8-bit activations ``x``
``[M, K]`` uint8 or int8; :func:`bitserial_matmul_a4` takes 4-bit
activations nibble-packed two per byte (:func:`pack_activation_nibbles`)
and at most 4 planes.  The epilogue returns the exact int32 accumulator
(``out_dtype=torch.int32``) or the dequantized
``f32(acc) * x_scale * w_scale[n]``.  ``plane_mask`` is the per-(plane,
K-block, N-block) int8 occupancy of the reference kernels
(``repro.kernels.bitserial_matmul.plane_block_mask``): a zero entry drops
that plane's contribution on that block.

The wrappers launch the CUDA kernels in ``src/repro_torch/csrc/``
(``bitserial_gemm.cu``, ``bitserial_gemm_a4.cu``) for CUDA tensors and run
the plain versions for CPU tensors.  Both kernels run the int8 tensor-core
main loop of ``csrc/int8_mma.cuh``: each weight tile is decoded once (plane
weights and mask folded into one 8-bit weight per element; the W4A4
kernel also widens the nibbles to bytes) and multiplied once; where the
output tiles cannot fill the card, :func:`split_k` splits K and the splits
add into an int32 workspace the wrapper allocates.  They never fall back
on a CUDA tensor: a kernel that does not build, or a launch that fails,
raises :class:`KernelError`, which the serving engine's recovery ladder
re-raises.  Each source is compiled with ``nvcc`` on first use into
``build/kernels/`` at the repository root, keyed by the hash of its text
and its headers', and loaded through ``ctypes``
(:mod:`repro_torch.kernels.cuda_build`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda_build import KernelError
from repro_torch.kernels import cuda_build as _cb

__all__ = ["KernelError", "bitserial_matmul", "bitserial_matmul_plain",
           "bitserial_matmul_a4", "bitserial_matmul_a4_plain",
           "pack_activation_nibbles", "unpack_activation_nibbles",
           "plane_block_mask", "split_k"]

DEFAULT_BK = 256  # the reference kernels' block sizes: the mask granularity
DEFAULT_BN = 128
DEFAULT_BK2 = DEFAULT_BK // 2  # packed activation bytes per a4 K-block

# the block tile (rows, columns, K step) of the int8 kernels' main loop
# (csrc/int8_mma.cuh; quant_gemm.cu also runs it as 64x128) and the card
# it is sized for (an H100 has 132 SMs)
TILE_M, TILE_N, TILE_K = 128, 64, 64
CARD_SMS = 132
SPLIT_TARGET_BLOCKS = 2 * CARD_SMS  # blocks a split-K launch aims for
SPLIT_MIN_STEPS = 2  # K steps each split walks at least


def split_k(M: int, N: int, K: int, tile_m: int = TILE_M,
            tile_n: int = TILE_N) -> tuple[int, int]:
    """``(splits, k_split)``: the number of K ranges an int8 kernel launches
    for an ``[M, K] x [K, N]`` product in ``tile_m x tile_n`` output tiles
    and the rows of each (a multiple of the kernel's K step; the last range
    ends at K).  K is split when the output tiles cannot fill the card, and
    whenever ``M <= 64`` with ``K >= 1024`` (a few rows over a long K), into
    enough ranges for about :data:`SPLIT_TARGET_BLOCKS` blocks, each walking
    at least :data:`SPLIT_MIN_STEPS` steps; none is empty."""
    steps = -(-K // TILE_K)
    tiles = -(-M // tile_m) * -(-N // tile_n)
    want = 1
    if tiles and (tiles < CARD_SMS or (M <= 64 and K >= 1024)):
        want = max(2, -(-SPLIT_TARGET_BLOCKS // tiles))
    want = min(want, steps // SPLIT_MIN_STEPS)
    if want <= 1:
        return 1, K
    per = -(-steps // want)
    return -(-steps // per), per * TILE_K


def plane_block_mask(planes: torch.Tensor, n_bits: int,
                     block_k: int = DEFAULT_BK,
                     block_n: int = DEFAULT_BN) -> torch.Tensor:
    """``[n_bits, ceil(K/bk), ceil(N/bn)]`` int8 occupancy of each plane
    block of byte-packed ``planes`` (block sizes clamped to K and N, as the
    reference kernel clamps them)."""
    K, N = planes.shape
    bk, bn = min(block_k, K), min(block_n, N)
    nk, nn = -(-K // bk), -(-N // bn)
    p = planes.to(torch.int64)
    padded = p.new_zeros((nk * bk, nn * bn))
    padded[:K, :N] = p
    blocks = padded.reshape(nk, bk, nn, bn)
    return torch.stack([((blocks >> b) & 1).sum(dim=(1, 3)) > 0
                        for b in range(n_bits)]).to(torch.int8)


def _plane_weight(b: int, n_bits: int, signed: bool) -> int:
    if signed and b == n_bits - 1:
        return -(1 << b)
    return 1 << b


def _check(x, planes, x_scale, w_scale, plane_mask, n_bits, out_dtype,
           block_k, block_n):
    """Validate the operands; returns ``(M, N, K, bk, bn)``."""
    if x.ndim != 2 or planes.ndim != 2:
        raise ValueError(f"x and planes must be 2-D, got {tuple(x.shape)} "
                         f"and {tuple(planes.shape)}")
    if x.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"x must be uint8 or int8, got {x.dtype}")
    if planes.dtype != torch.uint8:
        raise TypeError(f"planes must be byte-packed uint8, got {planes.dtype}")
    M, K = x.shape
    K2, N = planes.shape
    if K != K2:
        raise ValueError(f"x has K={K} but planes has K={K2}")
    if not 1 <= n_bits <= 8:
        raise ValueError(f"n_bits must be in 1..8, got {n_bits}")
    if out_dtype not in (torch.int32, torch.float32):
        raise TypeError(f"out_dtype must be int32 or float32, got {out_dtype}")
    if max(M, N, K) >= 1 << 31:
        raise ValueError(f"shape {(M, N, K)} exceeds the int32 index range")
    if w_scale is not None and tuple(w_scale.shape) != (N,):
        raise ValueError(f"w_scale must be [{N}], got {tuple(w_scale.shape)}")
    bk, bn = min(block_k, max(K, 1)), min(block_n, max(N, 1))
    if plane_mask is not None:
        want = (n_bits, -(-K // bk), -(-N // bn))
        if tuple(plane_mask.shape) != want:
            raise ValueError(f"plane_mask must be {want}, got "
                             f"{tuple(plane_mask.shape)}")
    return M, N, K, bk, bn


def _plain_gemm(xf: torch.Tensor, p: torch.Tensor, x_scale, w_scale,
                plane_mask, bk: int, bn: int, n_bits: int, out_dtype,
                signed: bool) -> torch.Tensor:
    """The bit-serial GEMM of float64 activations ``xf`` ``[M, K]`` and int64
    byte-packed planes ``p`` ``[K, N]`` in plain torch; the mask's K-blocks
    span ``bk`` rows.

    Each plane product runs as a float64 matmul: CUDA has no integer
    matmul, and float64 is exact here because every partial sum is an
    integer below ``K * 255 < 2^53``.  Plane sums accumulate in int64 and
    wrap to int32 at the end, which equals the kernels' modulo-2^32 int32
    accumulation."""
    M, K = xf.shape
    N = p.shape[1]
    acc = torch.zeros((M, N), dtype=torch.int64, device=xf.device)
    for b in range(n_bits):
        plane = (p >> b) & 1
        if plane_mask is not None:
            keep = plane_mask[b].to(torch.int64)
            keep = keep.repeat_interleave(bk, 0)[:K].repeat_interleave(bn, 1)[:, :N]
            plane = plane * keep
        part = (xf @ plane.to(torch.float64)).to(torch.int64)
        acc += _plane_weight(b, n_bits, signed) * part
    acc32 = (torch.remainder(acc + (1 << 31), 1 << 32) - (1 << 31)).to(torch.int32)
    if out_dtype == torch.int32:
        return acc32
    ws = (torch.ones(N, dtype=torch.float32, device=xf.device)
          if w_scale is None else w_scale.to(torch.float32))
    out = acc32.to(torch.float32) * torch.tensor(
        x_scale, dtype=torch.float32, device=xf.device)
    return out * ws[None, :]


def bitserial_matmul_plain(x: torch.Tensor, planes: torch.Tensor,
                           x_scale: float = 1.0,
                           w_scale: torch.Tensor | None = None,
                           plane_mask: torch.Tensor | None = None, *,
                           n_bits: int = 8, out_dtype=torch.float32,
                           signed: bool = True, block_k: int = DEFAULT_BK,
                           block_n: int = DEFAULT_BN) -> torch.Tensor:
    """The same function as :func:`bitserial_matmul` in plain torch, on the
    operands' device."""
    M, N, K, bk, bn = _check(x, planes, x_scale, w_scale, plane_mask, n_bits,
                             out_dtype, block_k, block_n)
    return _plain_gemm(x.to(torch.float64), planes.to(torch.int64), x_scale,
                       w_scale, plane_mask, bk, bn, n_bits, out_dtype, signed)


def _prepare_launch(tensors, w_scale, plane_mask, dev):
    """Validate that every operand of a kernel launch is a contiguous
    tensor on one CUDA device, with float32 scales and an int8 mask."""
    _cb.check_operands(tensors, dev)
    if w_scale is not None and w_scale.dtype != torch.float32:
        raise TypeError(f"w_scale must be float32, got {w_scale.dtype}")
    if plane_mask is not None and plane_mask.dtype != torch.int8:
        raise TypeError(f"plane_mask must be int8, got {plane_mask.dtype}")


def _repack_planes(planes: torch.Tensor) -> torch.Tensor:
    """Unpacked ``[n_bits, K, N]`` {0, 1} planes -> byte-packed ``[K, N]``."""
    shifts = torch.arange(planes.shape[0], dtype=torch.int64,
                          device=planes.device).reshape(-1, 1, 1)
    return ((planes.to(torch.int64) & 1) << shifts).sum(dim=0).to(
        torch.uint8)


def bitserial_matmul(x_q: torch.Tensor, planes: torch.Tensor,
                     x_scale: float = 1.0,
                     w_scale: torch.Tensor | None = None,
                     plane_mask: torch.Tensor | None = None, *,
                     n_bits: int | None = None, out_dtype=torch.float32,
                     signed: bool = True, block_k: int = DEFAULT_BK,
                     block_n: int = DEFAULT_BN) -> torch.Tensor:
    """Bit-serial GEMM (see the module docstring).  ``planes`` is the
    byte-packed ``[K, N]`` uint8 (``n_bits`` None means 8) or, as the
    reference accepts, a legacy unpacked ``[n_bits, K, N]`` {0, 1} stack,
    re-packed to bytes here (``n_bits`` is then its plane count).  CUDA
    tensors launch the Hopper kernel (and add one to
    ``bitserial_matmul.launches``, split K or not); CPU tensors run
    :func:`bitserial_matmul_plain`."""
    if planes.ndim == 3:
        n_bits = planes.shape[0]
        planes = _repack_planes(planes)
    elif n_bits is None:
        n_bits = 8
    if x_q.device.type == "cpu" and planes.device.type == "cpu":
        return bitserial_matmul_plain(
            x_q, planes, x_scale, w_scale, plane_mask, n_bits=n_bits,
            out_dtype=out_dtype, signed=signed, block_k=block_k,
            block_n=block_n)
    M, N, K, bk, bn = _check(x_q, planes, x_scale, w_scale, plane_mask, n_bits,
                             out_dtype, block_k, block_n)
    dev = x_q.device
    _prepare_launch([("x_q", x_q), ("planes", planes), ("w_scale", w_scale),
                     ("plane_mask", plane_mask)], w_scale, plane_mask, dev)
    if out_dtype == torch.float32 and w_scale is None:
        w_scale = torch.ones(N, dtype=torch.float32, device=dev)
    if -(-N // TILE_N) > 65535:
        raise ValueError(f"N={N} exceeds the launch range")
    splits, k_split = split_k(M, N, K)
    workspace = None
    if splits > 1 and M and N:
        # the splits add into zeroed int32 sums: the output itself for an
        # int32 result, else a workspace the float epilogue reads
        workspace = torch.zeros((M, N), dtype=torch.int32, device=dev)
    out = (workspace if workspace is not None and out_dtype == torch.int32
           else torch.empty((M, N), dtype=out_dtype, device=dev))
    if M == 0 or N == 0:
        return out
    lib = _cb.build("bitserial_gemm")
    nk, nn = -(-K // bk), -(-N // bn)
    with torch.cuda.device(dev):
        err = lib.bitserial_gemm(
            x_q.data_ptr(), int(x_q.dtype == torch.int8), planes.data_ptr(),
            plane_mask.data_ptr() if plane_mask is not None else None,
            bk, bn, nk, nn,
            w_scale.data_ptr() if w_scale is not None else None,
            float(x_scale), out.data_ptr(), int(out_dtype == torch.float32),
            workspace.data_ptr() if workspace is not None else None,
            M, N, K, k_split, n_bits, int(signed), _cb.launch_stream(dev))
    _cb.raise_on_error(err, "bitserial_gemm")
    bitserial_matmul.launches += 1
    return out


bitserial_matmul.launches = 0


# ---------------------------------------------------------------------------
# W4A4: nibble-packed activations, at most 4 weight planes.
# ---------------------------------------------------------------------------
def pack_activation_nibbles(x_q: torch.Tensor) -> torch.Tensor:
    """4-bit activations ``[M, K]`` (any integer dtype; the low nibble of
    each value is kept, two's complement for negatives) -> ``[M,
    ceil(K/2)]`` uint8, two elements per byte with the even element in the
    low nibble (``repro.kernels.ref.pack_activation_nibbles``)."""
    x = x_q.to(torch.int64)
    if x.shape[-1] % 2:
        x = torch.nn.functional.pad(x, (0, 1))
    lo = x[:, 0::2] & 0xF
    hi = x[:, 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_activation_nibbles(packed: torch.Tensor, K: int) -> torch.Tensor:
    """Inverse of :func:`pack_activation_nibbles`: ``[M, K2]`` uint8 ->
    ``[M, K]`` int8 with 4-bit sign extension."""
    b = packed.to(torch.int64)
    even = ((b & 0xF) ^ 8) - 8
    odd = ((b >> 4) ^ 8) - 8
    full = torch.stack([even, odd], dim=-1).reshape(b.shape[0], -1)
    return full[:, :K].to(torch.int8)


def _check_a4(x_packed, planes, w_scale, plane_mask, n_bits, out_dtype,
              block_k2, block_n):
    """Validate the W4A4 operands; returns ``(M, N, K, K2, bk2, bn)``."""
    if x_packed.ndim != 2 or planes.ndim != 2:
        raise ValueError(f"x_packed and planes must be 2-D, got "
                         f"{tuple(x_packed.shape)} and {tuple(planes.shape)}")
    if x_packed.dtype != torch.uint8:
        raise TypeError(f"x_packed must be nibble-packed uint8, got "
                        f"{x_packed.dtype}")
    if planes.dtype != torch.uint8:
        raise TypeError(f"planes must be byte-packed uint8, got {planes.dtype}")
    M, K2 = x_packed.shape
    K, N = planes.shape
    if not K <= 2 * K2:
        raise ValueError(f"x_packed holds {2 * K2} nibbles per row but "
                         f"planes has K={K}")
    if not 1 <= n_bits <= 4:
        raise ValueError(f"n_bits must be in 1..4, got {n_bits}")
    if out_dtype not in (torch.int32, torch.float32):
        raise TypeError(f"out_dtype must be int32 or float32, got {out_dtype}")
    if max(M, N, 2 * K2) >= 1 << 31:
        raise ValueError(f"shape {(M, N, K)} exceeds the int32 index range")
    if w_scale is not None and tuple(w_scale.shape) != (N,):
        raise ValueError(f"w_scale must be [{N}], got {tuple(w_scale.shape)}")
    bk2, bn = min(block_k2, max(K2, 1)), min(block_n, max(N, 1))
    if plane_mask is not None:
        want = (n_bits, -(-K2 // bk2), -(-N // bn))
        if tuple(plane_mask.shape) != want:
            raise ValueError(f"plane_mask must be {want}, got "
                             f"{tuple(plane_mask.shape)}")
    return M, N, K, K2, bk2, bn


def bitserial_matmul_a4_plain(x_packed: torch.Tensor, planes: torch.Tensor,
                              x_scale: float = 1.0,
                              w_scale: torch.Tensor | None = None,
                              plane_mask: torch.Tensor | None = None, *,
                              n_bits: int = 4, out_dtype=torch.float32,
                              signed: bool = True,
                              block_k2: int = DEFAULT_BK2,
                              block_n: int = DEFAULT_BN) -> torch.Tensor:
    """The same function as :func:`bitserial_matmul_a4` in plain torch, on
    the operands' device: unpack the nibbles, pad an odd K's dangling
    weight row with zeros, and run the 8-bit plain GEMM with the mask's
    K-blocks spanning ``2 * block_k2`` rows."""
    M, N, K, K2, bk2, bn = _check_a4(x_packed, planes, w_scale, plane_mask,
                                     n_bits, out_dtype, block_k2, block_n)
    b = x_packed.to(torch.int64)
    if signed:
        even, odd = ((b & 0xF) ^ 8) - 8, ((b >> 4) ^ 8) - 8
    else:
        even, odd = b & 0xF, b >> 4
    xf = torch.stack([even, odd], dim=-1).reshape(M, 2 * K2)
    p = planes.to(torch.int64)
    if K < 2 * K2:
        p = torch.nn.functional.pad(p, (0, 0, 0, 2 * K2 - K))
    return _plain_gemm(xf.to(torch.float64), p, x_scale, w_scale, plane_mask,
                       2 * bk2, bn, n_bits, out_dtype, signed)


def _launch_a4(x_packed, planes, x_scale, w_scale, plane_mask, *, n_bits,
               out_dtype, x_signed, signed, block_k2, block_n):
    """Check the operands and launch ``bitserial_gemm_a4`` on their CUDA
    device, the nibbles sign-extended when ``x_signed`` and the MSB plane
    negative when ``signed`` (:func:`bitserial_matmul_a4` passes one flag
    for both); returns the output, launched unless it is empty.  Counts
    nothing."""
    M, N, K, K2, bk2, bn = _check_a4(x_packed, planes, w_scale, plane_mask,
                                     n_bits, out_dtype, block_k2, block_n)
    dev = x_packed.device
    _prepare_launch([("x_packed", x_packed), ("planes", planes),
                     ("w_scale", w_scale), ("plane_mask", plane_mask)],
                    w_scale, plane_mask, dev)
    if out_dtype == torch.float32 and w_scale is None:
        w_scale = torch.ones(N, dtype=torch.float32, device=dev)
    if -(-N // TILE_N) > 65535:
        raise ValueError(f"N={N} exceeds the launch range")
    splits, k_split = split_k(M, N, K)
    workspace = None
    if splits > 1 and M and N:
        workspace = torch.zeros((M, N), dtype=torch.int32, device=dev)
    out = (workspace if workspace is not None and out_dtype == torch.int32
           else torch.empty((M, N), dtype=out_dtype, device=dev))
    if M == 0 or N == 0:
        return out
    lib = _cb.build("bitserial_gemm_a4")
    nk, nn = -(-K2 // bk2), -(-N // bn)
    with torch.cuda.device(dev):
        err = lib.bitserial_gemm_a4(
            x_packed.data_ptr(), int(x_signed), planes.data_ptr(),
            plane_mask.data_ptr() if plane_mask is not None else None,
            2 * bk2, bn, nk, nn,
            w_scale.data_ptr() if w_scale is not None else None,
            float(x_scale), out.data_ptr(), int(out_dtype == torch.float32),
            workspace.data_ptr() if workspace is not None else None,
            M, N, K, K2, k_split, n_bits, int(signed),
            _cb.launch_stream(dev))
    _cb.raise_on_error(err, "bitserial_gemm_a4")
    return out


def bitserial_matmul_a4(x_packed: torch.Tensor, planes: torch.Tensor,
                        x_scale: float = 1.0,
                        w_scale: torch.Tensor | None = None,
                        plane_mask: torch.Tensor | None = None, *,
                        n_bits: int = 4, out_dtype=torch.float32,
                        signed: bool = True, block_k2: int = DEFAULT_BK2,
                        block_n: int = DEFAULT_BN) -> torch.Tensor:
    """W4A4 bit-serial GEMM with nibble-packed activations ``x_packed``
    ``[M, ceil(K/2)]`` and byte-packed planes ``[K, N]`` (``n_bits <= 4``).
    ``signed`` sign-extends the nibbles and gives the MSB plane weight
    ``-2^(n-1)``; unsigned reads both as plain binary.  ``plane_mask`` is
    ``[n_bits, ceil(K2/bk2), ceil(N/bn)]`` with K-blocks of ``2 * bk2``
    weight rows.  CUDA tensors launch the Hopper kernel (and add one to
    ``bitserial_matmul_a4.launches``, split K or not); CPU tensors run
    :func:`bitserial_matmul_a4_plain`."""
    if x_packed.device.type == "cpu" and planes.device.type == "cpu":
        return bitserial_matmul_a4_plain(
            x_packed, planes, x_scale, w_scale, plane_mask, n_bits=n_bits,
            out_dtype=out_dtype, signed=signed, block_k2=block_k2,
            block_n=block_n)
    out = _launch_a4(x_packed, planes, x_scale, w_scale, plane_mask,
                     n_bits=n_bits, out_dtype=out_dtype, x_signed=signed,
                     signed=signed, block_k2=block_k2, block_n=block_n)
    if out.numel():
        bitserial_matmul_a4.launches += 1
    return out


bitserial_matmul_a4.launches = 0
