"""Backend registry for the packed bit-serial dot (``bitserial.packed_dot_words``).

The same contract as ``repro.core.backends``:

* **Backends re-time execution, never the model.**  ``dot_words`` returns
  values only; cycles are charged by ``bitserial.packed_dot_words`` before
  dispatch.
* **Byte-identity.**  Every backend reproduces the exact bit-serial walk.
  A backend may delegate inputs outside its native envelope to ``walk``;
  delegations are counted in :func:`dispatch_stats`.
* **Selection is configuration.**  Explicit ``engine=`` > the plan's
  ``backend`` field > the ``NC_TORCH_BACKEND`` environment variable > the
  default (``gemm``).

Registered backends
-------------------

``walk``
    The exact bit-serial walk (``bitserial._dot_words_impl``), the
    counterpart of the reference's ``host``.  Any plane width, accumulator
    width and row layout, on either device.
``gemm``
    The counterpart of the reference's ``pallas-interpret`` adapter: decode
    both row-aligned word grids to integer row matrices on the tensors'
    device, run ``kernels.ops.bitserial_matmul_exact`` (the Hopper kernel on
    a CUDA tensor, its plain version on a CPU tensor) and scatter the int32
    result back into the broadcast grid.  Rows sharing words (``K <= 16``)
    are decoded natively.  Delegated to ``walk``: more than 8 planes, an
    accumulator narrower than the product, a possible int32 overflow, and
    grids that do not separate.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from repro_torch.core import bitserial as bs

__all__ = [
    "Backend",
    "ENV_VAR",
    "DEFAULT",
    "register_backend",
    "registered_backends",
    "get_backend",
    "env_backend",
    "resolve_backend",
    "dispatch_stats",
    "dispatch_stats_clear",
]

ENV_VAR = "NC_TORCH_BACKEND"
DEFAULT = "gemm"


@dataclasses.dataclass(frozen=True)
class Backend:
    """One registered execution body for the packed bit-serial dot.

    ``dot_words(xw, ww, *, K, acc_bits)`` returns int64 row values.
    ``max_grid_words`` caps the broadcast word grid one call may span (the
    walk materializes it per plane); callers split larger work into row
    chunks.  None means unbounded."""

    name: str
    max_grid_words: int | None
    dot_words: Callable[..., torch.Tensor]


_REGISTRY: dict[str, Backend] = {}
# per-backend dispatch counters: name -> [native, delegated-to-walk]
_DISPATCH: dict[str, list[int]] = {}


def register_backend(backend: Backend) -> Backend:
    _REGISTRY[backend.name] = backend
    _DISPATCH.setdefault(backend.name, [0, 0])
    return backend


def registered_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str, source: str = "engine") -> Backend:
    """Look up a backend by name; unknown names raise a :class:`ValueError`
    naming every registered backend."""
    backend = _REGISTRY.get(name)
    if backend is None:
        raise ValueError(
            f"unknown backend {name!r} (from {source}); registered "
            f"backends: {', '.join(registered_backends())}")
    return backend


def env_backend() -> str | None:
    """The ``NC_TORCH_BACKEND`` selection, validated, or None when unset."""
    name = os.environ.get(ENV_VAR)
    if not name:
        return None
    return get_backend(name, source=f"{ENV_VAR} environment variable").name


def resolve_backend(explicit: str | None = None,
                    plan_backend: str | None = None) -> str:
    """Explicit ``engine=`` > plan's ``backend`` > ``NC_TORCH_BACKEND`` >
    ``gemm``.  Callers raise on an explicit engine contradicting the plan
    before resolving."""
    if explicit is not None:
        return get_backend(explicit).name
    if plan_backend is not None:
        return get_backend(plan_backend, source="plan backend").name
    return env_backend() or DEFAULT


def dispatch_stats() -> dict[str, dict[str, int]]:
    """``{name: {"native": n, "fallback": m}}`` since the last clear;
    ``fallback`` counts calls delegated to ``walk``."""
    return {name: {"native": c[0], "fallback": c[1]}
            for name, c in _DISPATCH.items()}


def dispatch_stats_clear() -> None:
    for c in _DISPATCH.values():
        c[0] = c[1] = 0


def _note(name: str, native: bool) -> None:
    _DISPATCH[name][0 if native else 1] += 1


# ---------------------------------------------------------------------------
# walk — the exact bit-serial body
# ---------------------------------------------------------------------------
def _walk_dot_words(xw, ww, *, K: int, acc_bits: int) -> torch.Tensor:
    _note("walk", native=True)
    return bs._dot_words_impl(xw, ww, K=K, acc_bits=acc_bits)


# ---------------------------------------------------------------------------
# gemm — decode to integer rows, run the bit-serial GEMM kernel
# ---------------------------------------------------------------------------
def _decode_rows(words: torch.Tensor, K: int) -> torch.Tensor:
    """Row-aligned word grid -> int64 lane values.

    ``P >= 32``: ``(n, *grid, wpr)`` -> ``(*grid, K)``.  ``P < 32``:
    ``(n, *grid)`` -> ``(*grid, r, K)`` — each word holds ``r`` rows."""
    P, wpr, r = bs._row_layout(K)
    n = words.shape[0]
    vals = None
    for p in range(n):
        v = bs._unpack_bits32(words[p]) << p  # (*grid[, wpr], 32)
        vals = v if vals is None else vals | v
    if r == 1:
        vals = vals.reshape(tuple(vals.shape[:-2]) + (-1,))
        return vals[..., :K]
    return vals.reshape(tuple(vals.shape[:-1]) + (r, P))[..., :K]


def _row_grid(words: torch.Tensor, K: int):
    """Decode one operand to ``(rows [R, K], grid)`` where ``grid`` is its
    row grid: for ``P < 32`` the last word axis expands to rows, unless the
    operand broadcasts along it (size 1) with every segment equal, in which
    case it stays one row."""
    P, wpr, r = bs._row_layout(K)
    vals = _decode_rows(words, K)
    if r == 1:
        grid = tuple(words.shape[1:-1])
        return vals.reshape(-1, K), grid
    grid = tuple(words.shape[1:])
    if grid[-1] == 1 and bool((vals == vals[..., :1, :]).all()):
        return vals[..., 0, :].reshape(-1, K), grid
    return vals.reshape(-1, K), grid[:-1] + (grid[-1] * r,)


def _gemm_fallback_reason(xw, ww, *, K: int, acc_bits: int) -> str | None:
    nx, nw = int(xw.shape[0]), int(ww.shape[0])
    if nx > 8 or nw > 8:
        return "more than 8 bit planes"
    if acc_bits < nx + nw:
        return "accumulator narrower than the product"
    if K * ((1 << nx) - 1) * ((1 << nw) - 1) >= (1 << 31):
        return "int32 accumulator overflow"
    if xw.ndim != ww.ndim:
        return "grid ranks differ"
    return None


def _gemm_dot_words(xw, ww, *, K: int, acc_bits: int) -> torch.Tensor:
    """Decode the two row-aligned word grids to integer row matrices, run the
    bit-serial GEMM and scatter the exact int32 result into the broadcast
    grid (each grid axis is owned by at most one operand)."""
    from repro_torch.kernels import ops

    reason = _gemm_fallback_reason(xw, ww, K=K, acc_bits=acc_bits)
    if reason is None:
        X, gx = _row_grid(xw, K)
        W, gw = _row_grid(ww, K)
        if any(a > 1 and b > 1 for a, b in zip(gx, gw)):
            reason = "non-separable broadcast grids"
    if reason is not None:
        _note("gemm", native=False)
        return bs._dot_words_impl(xw, ww, K=K, acc_bits=acc_bits)
    _note("gemm", native=True)

    P, wpr, r = bs._row_layout(K)
    planes = W.t().contiguous().to(torch.uint8)  # [K, Rw]: byte-packed planes
    out = ops.bitserial_matmul_exact(X.to(torch.uint8).contiguous(), planes,
                                     n_bits=int(ww.shape[0]))
    O = out.to(torch.int64).reshape(gx + gw)
    n_axes = len(gx)
    O = O.permute([a for i in range(n_axes) for a in (i, n_axes + i)])
    O = O.reshape(torch.broadcast_shapes(gx, gw))
    if r == 1:
        return O
    full = tuple(torch.broadcast_shapes(xw.shape[1:], ww.shape[1:]))
    return O.expand(full[:-1] + (full[-1] * r,))


register_backend(Backend(name="walk", max_grid_words=1 << 22,
                         dot_words=_walk_dot_words))
register_backend(Backend(name="gemm", max_grid_words=None,
                         dot_words=_gemm_dot_words))

