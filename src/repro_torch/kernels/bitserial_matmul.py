"""Bit-serial GEMM: the hand-written Hopper kernel, its build and its plain
version.

    out = sum_b pw[b] * (x @ plane_b),  pw[b] = 2^b  (MSB: -2^(n-1) if signed)

``planes`` is the byte-packed ``[K, N]`` uint8 format (bit ``b`` of each byte
is plane ``b``); ``x`` is ``[M, K]`` uint8 or int8.  The epilogue returns the
exact int32 accumulator (``out_dtype=torch.int32``) or the dequantized
``f32(acc) * x_scale * w_scale[n]``.  ``plane_mask`` is the
``[n_bits, ceil(K/block_k), ceil(N/block_n)]`` int8 occupancy of the
reference kernel (``repro.kernels.bitserial_matmul.plane_block_mask``): a
zero entry drops that plane's contribution on that block.

:func:`bitserial_matmul` launches the CUDA kernel in
``src/repro_torch/csrc/bitserial_gemm.cu`` for CUDA tensors and runs
:func:`bitserial_matmul_plain` for CPU tensors.  It never falls back on a
CUDA tensor: a kernel that does not build, or a launch that fails, raises
:class:`KernelError`, which the serving engine's recovery ladder re-raises.
The kernel is compiled with ``nvcc`` on first use into ``build/kernels/``
at the repository root and loaded through ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

__all__ = ["KernelError", "bitserial_matmul", "bitserial_matmul_plain",
           "build", "build_log", "plane_block_mask"]

DEFAULT_BK = 256  # the reference kernel's block sizes: the mask granularity
DEFAULT_BN = 128

_SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "bitserial_gemm.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """The kernel did not build or its launch failed."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: the bitserial_gemm kernel cannot be "
                      "built (install the CUDA toolkit or put nvcc on PATH)")


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library.  The
    compiler's ``-Xptxas -v`` report is kept beside it (``build_log``)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
        lib_path = _BUILD_DIR / f"libbitserial_gemm-{digest}.so"
        if not lib_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, str(_SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise KernelError(f"nvcc failed ({proc.returncode}):\n"
                                  f"{proc.stderr}")
            os.replace(tmp, lib_path)
            # keep the compiler's report (registers, shared memory, spills)
            lib_path.with_suffix(".log").write_text(proc.stderr)
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            raise KernelError(f"cannot load {lib_path}: {e}") from e
        fn = lib.bitserial_gemm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
        return lib


def build_log() -> str:
    """The ``-Xptxas -v`` report of the current source's build ('' if the
    library was built elsewhere)."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    log = _BUILD_DIR / f"libbitserial_gemm-{digest}.log"
    return log.read_text() if log.exists() else ""


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


def bitserial_matmul_plain(x: torch.Tensor, planes: torch.Tensor,
                           x_scale: float = 1.0,
                           w_scale: torch.Tensor | None = None,
                           plane_mask: torch.Tensor | None = None, *,
                           n_bits: int = 8, out_dtype=torch.float32,
                           signed: bool = True, block_k: int = DEFAULT_BK,
                           block_n: int = DEFAULT_BN) -> torch.Tensor:
    """The same function in plain torch, on the operands' device.

    Each plane product runs as a float64 matmul: CUDA has no integer
    matmul, and float64 is exact here because every partial sum is an
    integer below ``K * 255 < 2^53``.  Plane sums accumulate in int64 and
    wrap to int32 at the end, which equals the kernel's modulo-2^32 int32
    accumulation."""
    M, N, K, bk, bn = _check(x, planes, x_scale, w_scale, plane_mask, n_bits,
                             out_dtype, block_k, block_n)
    xf = x.to(torch.float64)
    p = planes.to(torch.int64)
    acc = torch.zeros((M, N), dtype=torch.int64, device=x.device)
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
    ws = (torch.ones(N, dtype=torch.float32, device=x.device)
          if w_scale is None else w_scale.to(torch.float32))
    out = acc32.to(torch.float32) * torch.tensor(
        x_scale, dtype=torch.float32, device=x.device)
    return out * ws[None, :]


def bitserial_matmul(x: torch.Tensor, planes: torch.Tensor,
                     x_scale: float = 1.0,
                     w_scale: torch.Tensor | None = None,
                     plane_mask: torch.Tensor | None = None, *,
                     n_bits: int = 8, out_dtype=torch.float32,
                     signed: bool = True, block_k: int = DEFAULT_BK,
                     block_n: int = DEFAULT_BN) -> torch.Tensor:
    """Bit-serial GEMM (see the module docstring).  CUDA tensors launch the
    Hopper kernel (and add one to ``bitserial_matmul.launches``); CPU
    tensors run :func:`bitserial_matmul_plain`."""
    if x.device.type == "cpu" and planes.device.type == "cpu":
        return bitserial_matmul_plain(
            x, planes, x_scale, w_scale, plane_mask, n_bits=n_bits,
            out_dtype=out_dtype, signed=signed, block_k=block_k,
            block_n=block_n)
    M, N, K, bk, bn = _check(x, planes, x_scale, w_scale, plane_mask, n_bits,
                             out_dtype, block_k, block_n)
    dev = x.device
    tensors = [("x", x), ("planes", planes), ("w_scale", w_scale),
               ("plane_mask", plane_mask)]
    for name, t in tensors:
        if t is None:
            continue
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every operand on one CUDA device ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w_scale is not None and w_scale.dtype != torch.float32:
        raise TypeError(f"w_scale must be float32, got {w_scale.dtype}")
    if plane_mask is not None and plane_mask.dtype != torch.int8:
        raise TypeError(f"plane_mask must be int8, got {plane_mask.dtype}")
    if out_dtype == torch.float32 and w_scale is None:
        w_scale = torch.ones(N, dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return out
    lib = build()
    nk, nn = -(-K // bk), -(-N // bn)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bitserial_gemm(
            x.data_ptr(), int(x.dtype == torch.int8), planes.data_ptr(),
            plane_mask.data_ptr() if plane_mask is not None else None,
            bk, bn, nk, nn,
            w_scale.data_ptr() if w_scale is not None else None,
            float(x_scale), out.data_ptr(), int(out_dtype == torch.float32),
            M, N, K, n_bits, int(signed), stream)
    if err != 0:
        raise KernelError(f"bitserial_gemm launch failed: cudaError_t {err}")
    bitserial_matmul.launches += 1
    return out


bitserial_matmul.launches = 0
