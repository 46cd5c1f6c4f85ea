"""W8A8 GEMM with the dequantization epilogue fused: the hand-written Hopper
kernel and its plain version.

    out[m, n] = f32(sum_k x[m, k] * w[k, n]) * x_scale * w_scale[n] (+ bias[n])

``x`` is ``[M, K]`` int8, ``w`` ``[K, N]`` int8, ``x_scale`` a scalar,
``w_scale`` and ``bias`` ``[N]`` float32; the result is ``[M, N]``
float32.  The accumulator is exact int32 and the epilogue multiplies and
adds in float32 in the reference's order (``repro.kernels.quant_matmul``),
each step rounded to nearest, so the kernel and :func:`quant_matmul_plain`
agree bit for bit.

:func:`quant_matmul` launches ``src/repro_torch/csrc/quant_gemm.cu`` for
CUDA tensors (and adds one to ``quant_matmul.launches``) and runs
:func:`quant_matmul_plain` for CPU tensors.  The kernel runs the int8
tensor-core main loop of ``csrc/int8_mma.cuh`` in 64x128 tiles, split
along K where :func:`quant_split_k` says so; the splits add into an int32
workspace the wrapper allocates, and a second launch applies the epilogue.
It never falls back on a CUDA tensor: a kernel that does not build, or a
launch that fails, raises
:class:`~repro_torch.kernels.cuda_build.KernelError`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build as _cb
from repro_torch.kernels.bitserial_matmul import CARD_SMS, split_k

__all__ = ["quant_matmul", "quant_matmul_plain", "quant_split_k"]

QUANT_TILE_M, QUANT_TILE_N = 64, 128  # quant_gemm.cu's output tile


def quant_split_k(M: int, N: int, K: int) -> tuple[int, int]:
    """``(splits, k_split)`` for an ``[M, K] x [K, N]`` W8A8 product in
    the kernel's 64x128 tiles: :func:`split_k`'s ranges where the tiles
    cannot fill the card, else one range (a few rows against wide weights,
    as at the LM head, already make enough tiles)."""
    tiles = -(-M // QUANT_TILE_M) * -(-N // QUANT_TILE_N)
    if tiles >= CARD_SMS:
        return 1, K
    return split_k(M, N, K, QUANT_TILE_M, QUANT_TILE_N)


def _check(x_q, w_q, w_scale, bias):
    """Validate the operands; returns ``(M, N, K)``."""
    if x_q.ndim != 2 or w_q.ndim != 2:
        raise ValueError(f"x_q and w_q must be 2-D, got {tuple(x_q.shape)} "
                         f"and {tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype} and "
                        f"{w_q.dtype}")
    M, K = x_q.shape
    K2, N = w_q.shape
    if K != K2:
        raise ValueError(f"x_q has K={K} but w_q has K={K2}")
    if max(M, N, K) >= 1 << 31 or -(-N // QUANT_TILE_N) > 65535:
        raise ValueError(f"shape {(M, N, K)} exceeds the launch range")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is None:
            continue
        if tuple(t.shape) != (N,):
            raise ValueError(f"{name} must be [{N}], got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    return M, N, K


def quant_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor, x_scale,
                       w_scale: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """The same function as :func:`quant_matmul` in plain torch, on the
    operands' device.  The product runs as a float64 matmul of the int8
    operands, exact because every partial sum is an integer below 2^53;
    the epilogue follows in float32 in the kernel's order."""
    M, N, K = _check(x_q, w_q, w_scale, bias)
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)
    xs = torch.tensor(float(x_scale), dtype=torch.float32, device=x_q.device)
    out = acc.to(torch.float32) * xs
    out = out * w_scale[None, :]
    if bias is not None:
        out = out + bias[None, :]
    return out


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale,
                 w_scale: torch.Tensor,
                 bias: torch.Tensor | None = None, *,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """W8A8 GEMM (see the module docstring).  CUDA tensors launch the Hopper
    kernel (split K or not, one count); CPU tensors run
    :func:`quant_matmul_plain`.  The float32 result is cast to
    ``out_dtype``, as the reference's epilogue casts it."""
    if x_q.device.type == "cpu" and w_q.device.type == "cpu":
        out = quant_matmul_plain(x_q, w_q, x_scale, w_scale, bias)
    else:
        out = _launch(x_q, w_q, x_scale, w_scale, bias)
    return out if out_dtype == torch.float32 else out.to(out_dtype)


def _launch(x_q, w_q, x_scale, w_scale, bias) -> torch.Tensor:
    """One launch of ``quant_gemm.cu`` on CUDA operands (float32 result)."""
    M, N, K = _check(x_q, w_q, w_scale, bias)
    dev = x_q.device
    _cb.check_operands([("x_q", x_q), ("w_q", w_q), ("w_scale", w_scale),
                        ("bias", bias)], dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    splits, k_split = quant_split_k(M, N, K)
    workspace = (torch.zeros((M, N), dtype=torch.int32, device=dev)
                 if splits > 1 else None)
    lib = _cb.build("quant_gemm")
    with torch.cuda.device(dev):
        err = lib.quant_gemm(
            x_q.data_ptr(), w_q.data_ptr(), float(x_scale),
            w_scale.data_ptr(), bias.data_ptr() if bias is not None else None,
            out.data_ptr(),
            workspace.data_ptr() if workspace is not None else None,
            M, N, K, k_split, _cb.launch_stream(dev))
    _cb.raise_on_error(err, "quant_gemm")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
