"""Flash attention (GQA, causal or full): the hand-written Hopper kernel and
its plain version.

``q`` is ``[B, H, Tq, D]``, ``k`` and ``v`` ``[B, Hkv, Tk, D]`` (bfloat16 or
float32, one dtype); query head ``h`` reads KV head ``h // (H // Hkv)``.
The arithmetic is the TPU kernel's (``repro.kernels.flash_attention``):
q, k and v taken to float32, scores scaled by ``1/sqrt(D)``, the causal
mask ``kpos <= qpos`` counted from 0 for both, masked scores at
``NEG_INF = -1e30``, an online softmax over KV tiles with a running max and
sum in float32, and ``acc / max(l, 1e-30)`` returned in q's dtype.  Unlike
the TPU kernel, any Tq and Tk are taken (ragged tiles are masked).

:func:`flash_attention` launches ``src/repro_torch/csrc/flash_attention.cu``
for CUDA tensors (and adds one to ``flash_attention.launches``) and runs
:func:`flash_attention_plain` for CPU tensors.  bfloat16 runs on the
tensor cores: f32-accumulated products, with p split into two bf16 terms
``hi + lo`` for P.V so that the TPU kernel's f32 p is kept to about 2^-17
(:func:`kernel_tiles` reports the tiles); float32 runs on the CUDA cores.
It never falls back on a CUDA tensor: a kernel that does not build, or a
launch that fails, raises
:class:`~repro_torch.kernels.cuda_build.KernelError`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda_build as _cb

__all__ = ["flash_attention", "flash_attention_plain", "kernel_tiles",
           "NEG_INF", "DEFAULT_BQ", "DEFAULT_BK"]

NEG_INF = -1e30
DEFAULT_BQ = 64  # the CUDA kernel's tiles
DEFAULT_BK = 64
HEAD_DIMS = (16, 32, 64, 128)  # head sizes the CUDA kernel is built for


def _check(q, k, v):
    """Validate the operands; returns ``(B, H, Hkv, Tq, Tk, D)``."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be [B, H, T, D]")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in (torch.bfloat16,
                                                            torch.float32):
        raise TypeError(f"q, k and v must share bfloat16 or float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Tk, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be [{B}, Hkv, Tk, {D}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    return B, H, Hkv, Tq, Tk, D


def _scale(D: int) -> float:
    return 1.0 / math.sqrt(D)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, bq: int = DEFAULT_BQ,
                          bk: int = DEFAULT_BK) -> torch.Tensor:
    """The same function as :func:`flash_attention` in plain torch, on the
    operands' device: the online recurrence over KV tiles of ``bk`` keys,
    query rows in tiles of ``bq`` (memory only: rows are independent).  KV
    tiles wholly above the diagonal are skipped; they would add exactly
    nothing (scores at NEG_INF give p = 0 and a rescale of 1)."""
    B, H, Hkv, Tq, Tk, D = _check(q, k, v)
    G = H // Hkv
    scale = torch.tensor(_scale(D), dtype=torch.float32, device=q.device)
    qf = q.to(torch.float32).reshape(B, Hkv, G, Tq, D)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = torch.empty((B, Hkv, G, Tq, D), dtype=torch.float32,
                      device=q.device)
    for i0 in range(0, Tq, bq):
        qi = qf[:, :, :, i0:i0 + bq]
        qpos = torch.arange(i0, i0 + qi.shape[3], device=q.device)
        m = torch.full(qi.shape[:4], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qi)
        kv_end = min(Tk, i0 + qi.shape[3]) if causal else Tk
        for j0 in range(0, kv_end, bk):
            kj, vj = kf[:, :, j0:j0 + bk], vf[:, :, j0:j0 + bk]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj) * scale
            if causal:
                kpos = torch.arange(j0, j0 + kj.shape[2], device=q.device)
                s = torch.where(kpos[None, :] <= qpos[:, None], s,
                                torch.tensor(NEG_INF, device=q.device))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            c = torch.exp(m - m_new)
            l = l * c + p.sum(dim=-1)
            m = m_new
            acc = acc * c[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    vj)
        out[:, :, :, i0:i0 + qi.shape[3]] = acc / torch.clamp_min(
            l, 1e-30)[..., None]
    return out.reshape(B, H, Tq, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Tiled attention (see the module docstring).  CUDA tensors launch the
    Hopper kernel; CPU tensors run :func:`flash_attention_plain`.  The
    kernel has no backward, so under grad mode an operand that requires
    grad raises ``RuntimeError`` on every device (its output would carry
    no gradient)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: call it under torch.no_grad() "
            "or on operands that do not require grad")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal)
    B, H, Hkv, Tq, Tk, D = _check(q, k, v)
    if D not in HEAD_DIMS:
        raise ValueError(f"head size {D} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if (B * H > 65535 or -(-Tq // DEFAULT_BQ) > 65535
            or max(Tq, Tk) * D >= 1 << 31):
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch range")
    dev = q.device
    _cb.check_operands([("q", q), ("k", k), ("v", v)], dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             f"kernel copies rows 16 bytes at a time)")
    out = torch.empty_like(q)
    if B * H == 0 or Tq == 0:
        return out
    if Tk == 0:
        raise ValueError("no keys to attend to (Tk = 0)")
    lib = _cb.build("flash_attention")
    with torch.cuda.device(dev):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), B, H, Hkv, Tq, Tk, D, int(causal),
            _scale(D), _cb.launch_stream(dev))
    _cb.raise_on_error(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def kernel_tiles(dtype: torch.dtype = torch.bfloat16) -> dict:
    """The tiles the CUDA kernel runs for ``dtype``, as its source reports
    them: query rows per block, keys per KV tile, and the depth of the K/V
    ring in shared memory (1: loaded synchronously).  Builds the kernel."""
    fn = _cb.build("flash_attention").flash_attention_tiles
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    tiles = (ctypes.c_int * 3)()
    fn(int(dtype == torch.bfloat16), tiles)
    return dict(bq=tiles[0], bkv=tiles[1], stages=tiles[2])
