"""Build, load and launch checks shared by the hand-written Hopper kernels.

Each kernel is one CUDA C++ source ``src/repro_torch/csrc/<name>.cu`` with a
plain C launcher ``extern "C" int <name>(...)`` that returns the launch's
``cudaError_t``.  :func:`build_all` compiles the sources with ``nvcc -gencode
arch=compute_90a,code=sm_90a``, one process per source, all started
together, into ``build/kernels/`` at the repository root, each keyed by the
hash of its own text and of every ``csrc`` header it includes, and loads
them through ``ctypes``.  Nothing is built when a module is imported: the
first CUDA call of a wrapper builds its kernel, and a kernel that does not
build raises :class:`KernelError` there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading

import torch

__all__ = ["KernelError", "build", "build_all", "build_log",
           "check_operands", "launch_stream", "raise_on_error"]

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
_C = ctypes
_P, _I, _F = _C.c_void_p, _C.c_int, _C.c_float
# kernel name -> the ctypes signature of its launcher (the source is
# csrc/<name>.cu and the launcher is the extern "C" function <name>)
_SIGNATURES = {
    # x, x_signed, planes, mask, mask_bk, mask_bn, mask_nk, mask_nn, w_scale,
    # x_scale, out, out_float, workspace, M, N, K, k_split, n_bits,
    # signed_planes, stream
    "bitserial_gemm": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _F, _P, _I, _P, _I,
                       _I, _I, _I, _I, _I, _P],
    # x_packed, x_signed, planes, mask, mask_bk, mask_bn, mask_nk, mask_nn,
    # w_scale, x_scale, out, out_float, workspace, M, N, K, K2, k_split,
    # n_bits, signed_planes, stream
    "bitserial_gemm_a4": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _F, _P, _I, _P,
                          _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, x_scale, w_scale, bias, out, workspace, M, N, K, k_split, stream
    "quant_gemm": [_P, _P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, out, is_bf16, B, H, Hkv, Tq, Tk, D, causal, scale, stream
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                        _P],
}
_LIBS: dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A kernel did not build or its launch failed."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: the Hopper kernels cannot be built "
                      "(install the CUDA toolkit or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _lib_path(name: str, csrc: pathlib.Path = _CSRC) -> pathlib.Path:
    """The library of ``csrc/<name>.cu`` as its source stands: keyed by the
    source's text and that of every header it includes from ``csrc``
    (followed through the headers' own includes), so that editing a shared
    header rebuilds each kernel that includes it."""
    digest = hashlib.sha256()
    seen, todo = set(), [f"{name}.cu"]
    while todo:
        rel = todo.pop(0)
        if rel in seen:
            continue
        seen.add(rel)
        text = (csrc / rel).read_bytes()
        digest.update(rel.encode() + b"\0" + text + b"\0")
        todo += [m.decode() for m in _INCLUDE.findall(text)
                 if (csrc / m.decode()).is_file()]
    return _BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _load(name: str) -> ctypes.CDLL:
    lib_path = _lib_path(name)
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise KernelError(f"cannot load {lib_path}: {e}") from e
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return lib


def build_all(names=tuple(_SIGNATURES)) -> dict[str, ctypes.CDLL]:
    """Compile the kernels of ``names`` that are not built for their
    current source, one ``nvcc`` per source, all started together, then
    load them.  The compiler's ``-Xptxas -v`` report is kept beside each
    library (:func:`build_log`)."""
    with _LIB_LOCK:
        todo = [n for n in names if n not in _LIBS]
        procs = []
        for name in todo:
            lib_path = _lib_path(name)
            if lib_path.exists():
                continue
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, str(_CSRC / f"{name}.cu")]
            procs.append((name, lib_path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failures = []
        for name, lib_path, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                failures.append(f"{name}: nvcc failed ({proc.returncode}):\n"
                                f"{err}")
                continue
            os.replace(tmp, lib_path)
            # keep the compiler's report (registers, shared memory, spills)
            lib_path.with_suffix(".log").write_text(err)
        if failures:
            raise KernelError("\n".join(failures))
        for name in todo:
            _LIBS[name] = _load(name)
        return {n: _LIBS[n] for n in names}


def build(name: str) -> ctypes.CDLL:
    """Compile (once per source version) and load one kernel library."""
    if name not in _SIGNATURES:
        raise ValueError(f"unknown kernel {name!r}; known: "
                         f"{', '.join(_SIGNATURES)}")
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all((name,))[name]


def build_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the current source's build ('' if the
    library was built elsewhere)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check_operands(tensors, dev: torch.device) -> None:
    """Raise unless every operand ``(name, tensor)`` (None skipped) is a
    contiguous tensor on the one CUDA device ``dev``."""
    for name, t in tensors:
        if t is None:
            continue
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every operand on one CUDA device ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_stream(dev: torch.device) -> int:
    """PyTorch's current stream on ``dev``, as the launchers take it."""
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on_error(err: int, name: str) -> None:
    """Raise :class:`KernelError` for a launcher's non-zero ``cudaError_t``."""
    if err != 0:
        raise KernelError(f"{name} launch failed: cudaError_t {err}")
