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
  caller's default > ``gemm``.

Registered backends
-------------------

``walk``
    The exact bit-serial walk (``bitserial._dot_words_impl``), the
    counterpart of the reference's ``host``.  Any plane width, accumulator
    width and row layout, on either device.  Its multiply elides
    zero-operand words and dead planes (``bitserial.ZERO_SKIP``) and counts
    them in ``bitserial.SKIP_STATS``.
``gemm``
    The counterpart of the reference's ``pallas-interpret`` adapter: decode
    both row-aligned word grids to integer row matrices on the tensors'
    device, run ``kernels.ops.bitserial_matmul_exact`` (a Hopper kernel on
    a CUDA tensor, its plain version on a CPU tensor) and scatter the int32
    result back into the broadcast grid.  When both operands fit 4 planes
    and ``K >= 2`` the activations are nibble-packed and run through the
    W4A4 kernel, as the reference's adapter routes them; otherwise the
    8-bit kernel.  Rows sharing words (``K <= 16``) are decoded natively,
    and so are paired rows (``nc_dot``: both grids equal, row ``i`` dotted
    with row ``i``), as the diagonal of block products.  Delegated to
    ``walk``: more than 8 planes, an accumulator narrower than the product,
    a possible int32 overflow, and grids that neither separate nor pair.
    It performs no zero-operand elision and counts nothing in
    ``bitserial.SKIP_STATS`` on its native path.
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
    "default_backend",
    "resolve_backend",
    "dispatch_stats",
    "dispatch_stats_clear",
]

ENV_VAR = "NC_TORCH_BACKEND"
DEFAULT = "gemm"


@dataclasses.dataclass(frozen=True)
class Backend:
    """One registered execution body for the packed bit-serial dot.

    The capability flags describe the *native* envelope, as the
    reference's do; inputs outside it are delegated to ``walk``.
    ``dot_words(xw, ww, *, K, acc_bits)`` returns int64 row values.
    ``max_grid_words`` caps the broadcast word grid one call may span (the
    walk materializes it per plane); callers split larger work into row
    chunks.  None means unbounded.  It is not the reference's
    ``max_lane_words``, a cap on one operand above which the Pallas adapter
    delegates: ``gemm`` decodes operands of any size on the card, so the
    port has no such cap."""

    name: str
    # accumulator widths executed natively (None = any)
    acc_bits: tuple[int, ...] | None
    w4a4: bool  # dedicated nibble-packed path for <=4-plane operands
    compressed_planes: bool  # consumes CSR-reconstructed filter tiles
    integrity: bool  # safe under the ABFT checked/fault-injected path
    max_grid_words: int | None
    dot_words: Callable[..., torch.Tensor]

    def supports_acc(self, acc_bits: int) -> bool:
        return self.acc_bits is None or acc_bits in self.acc_bits


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


def default_backend() -> str:
    """``NC_TORCH_BACKEND`` when set (validated), else ``gemm``."""
    return env_backend() or DEFAULT


def resolve_backend(explicit: str | None = None,
                    plan_backend: str | None = None,
                    default: str | None = None) -> str:
    """Explicit ``engine=`` > plan's ``backend`` > ``NC_TORCH_BACKEND`` >
    ``default`` > ``gemm``.  Callers raise on an explicit engine
    contradicting the plan before resolving."""
    if explicit is not None:
        return get_backend(explicit).name
    if plan_backend is not None:
        return get_backend(plan_backend, source="plan backend").name
    if default is not None:
        default = get_backend(default, source="default").name
    return env_backend() or default or DEFAULT


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
    backend = _REGISTRY["gemm"]
    if not backend.supports_acc(acc_bits):
        return f"acc_bits={acc_bits} outside {backend.acc_bits}"
    if acc_bits < nx + nw:
        return "accumulator narrower than the product"
    if K * ((1 << nx) - 1) * ((1 << nw) - 1) >= (1 << 31):
        return "int32 accumulator overflow"
    if xw.ndim != ww.ndim:
        return "grid ranks differ"
    return None


PAIR_BLOCK = 1024  # rows of one diagonal block of a paired-row product


def _exact_gemm(X: torch.Tensor, W: torch.Tensor, nx: int,
                nw: int) -> torch.Tensor:
    """``X @ W.T`` exact int32 through the bit-serial kernel: the W4A4
    kernel on nibble-packed rows when both operands fit 4 planes and
    ``K >= 2``, else the 8-bit kernel."""
    from repro_torch.kernels import bitserial_matmul as _bsm
    from repro_torch.kernels import ops

    K = X.shape[1]
    planes = W.t().contiguous().to(torch.uint8)  # [K, Rw]: byte-packed planes
    if _REGISTRY["gemm"].w4a4 and nx <= 4 and nw <= 4 and K >= 2:
        return ops.bitserial_matmul_exact(
            _bsm.pack_activation_nibbles(X), planes, n_bits=nw, w4a4=True)
    return ops.bitserial_matmul_exact(X.to(torch.uint8).contiguous(),
                                      planes, n_bits=nw)


def _gemm_dot_words(xw, ww, *, K: int, acc_bits: int) -> torch.Tensor:
    """Decode the two row-aligned word grids to integer row matrices, run the
    bit-serial GEMM and scatter the exact int32 result into the broadcast
    grid.  Each grid axis is owned by at most one operand (a product over
    the rows of both), or every axis is shared (paired rows, as
    ``nc_dot``'s: row ``i`` dotted with row ``i``, the diagonal of
    ``PAIR_BLOCK``-row block products)."""
    reason = _gemm_fallback_reason(xw, ww, K=K, acc_bits=acc_bits)
    paired = False
    if reason is None:
        X, gx = _row_grid(xw, K)
        W, gw = _row_grid(ww, K)
        paired = gx == gw and bs._numel(gx) > 1
        if not paired and any(a > 1 and b > 1 for a, b in zip(gx, gw)):
            reason = "non-separable broadcast grids"
    if reason is not None:
        _note("gemm", native=False)
        return bs._dot_words_impl(xw, ww, K=K, acc_bits=acc_bits)
    _note("gemm", native=True)

    P, wpr, r = bs._row_layout(K)
    nx, nw = int(xw.shape[0]), int(ww.shape[0])
    if paired:
        O = torch.cat([
            torch.diagonal(_exact_gemm(X[i:i + PAIR_BLOCK],
                                       W[i:i + PAIR_BLOCK], nx, nw))
            for i in range(0, X.shape[0], PAIR_BLOCK)]).to(torch.int64)
        O = O.reshape(gx)
    else:
        O = _exact_gemm(X, W, nx, nw).to(torch.int64).reshape(gx + gw)
        n_axes = len(gx)
        O = O.permute([a for i in range(n_axes) for a in (i, n_axes + i)])
        O = O.reshape(torch.broadcast_shapes(gx, gw))
    if r == 1:
        return O
    full = tuple(torch.broadcast_shapes(xw.shape[1:], ww.shape[1:]))
    return O.expand(full[:-1] + (full[-1] * r,))


# The walk takes any accumulator and has no nibble route.  The gemm's
# int32 kernel sum is exact for any accumulator that holds the product (the
# log tree widens past it), so its width test stays operand-dependent in
# _gemm_fallback_reason; operands of <= 4 planes take the W4A4 kernel.
register_backend(Backend(
    name="walk", acc_bits=None, w4a4=False, compressed_planes=True,
    integrity=True, max_grid_words=1 << 22, dot_words=_walk_dot_words))
register_backend(Backend(
    name="gemm", acc_bits=None, w4a4=True, compressed_planes=True,
    integrity=True, max_grid_words=None, dot_words=_gemm_dot_words))

