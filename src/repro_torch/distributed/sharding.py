"""Sharding rules: named-parameter paths -> per-dimension mesh specs (the
port of ``repro.distributed.sharding``).

The rules are the reference's, on axis names and sizes only:

  * TP   — output-feature / expert / vocab / head dims on the ``model`` axis,
  * FSDP — the complementary weight dim on the ``data`` axis (ZeRO-3),
  * DP   — batch over ``("pod", "data")``; the ``pod`` axis replicates params,
  * EP   — the stacked expert axis of MoE weights on ``model``,
  * SP   — long-context KV/state caches sharded on the sequence dim.

Every rule is divisibility-checked.  A dim that does not divide its mesh axis
falls back to replication and the fallback is recorded in the
:class:`ShardingReport`, in the reference's words.

A spec is a tuple with one entry per tensor dim: an axis name, a tuple of
axis names (the dim split over several axes, major first) or ``None``
(replicated), the reference's ``PartitionSpec``.  :func:`to_placements`
turns it into DTensor :class:`~torch.distributed.tensor.Placement`s, one
per mesh dim, and :class:`NamedSharding` pairs a spec with its mesh.  The
rules read a mesh's ``mesh_dim_names`` and ``shape`` and nothing else, so a
:class:`~torch.distributed.device_mesh.DeviceMesh` and an
:class:`AbstractMesh` (names and sizes, no process group) both serve.

DTensor, like GSPMD, treats these specs as layouts, not as a rewrite of the
program: every op's sharding propagation inserts the collectives a layout
implies.  The rules encode the *performance* intent.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeSpec

__all__ = [
    "spec_for_param",
    "make_param_shardings",
    "make_batch_sharding",
    "make_cache_shardings",
    "plan_parallelism",
    "batch_axes",
    "to_placements",
    "distribute",
    "distribute_from_host",
    "is_dtensor",
    "rows_only",
    "rows_like",
    "local_rows",
    "spec_str",
    "AbstractMesh",
    "NamedSharding",
    "ShardingReport",
]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes without devices (the reference's
    ``FakeMesh`` stand-in): enough for every rule of this module."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def spec_str(spec: tuple) -> str:
    """The spec as the reference's ``str(PartitionSpec(...))``."""
    return "PartitionSpec" + repr(tuple(spec))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self):
        return to_placements(self.spec, self.mesh)


@dataclasses.dataclass
class ShardingReport:
    """Record of which rules fired and which fell back to replication."""

    assigned: dict[str, str] = dataclasses.field(default_factory=dict)
    fallbacks: list[str] = dataclasses.field(default_factory=list)

    def note(self, path: str, spec: tuple) -> None:
        self.assigned[path] = spec_str(spec)

    def fallback(self, path: str, dim: int, size: int, axis: str, n: int) -> None:
        self.fallbacks.append(
            f"{path}: dim {dim} ({size}) % mesh[{axis}]={n} != 0 -> replicated"
        )


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, axis: str) -> int:
    return _sizes(mesh).get(axis, 1)


def _fits(size: int, mesh, axis: str) -> bool:
    n = _axis_size(mesh, axis)
    return n > 1 and size % n == 0


def _maybe(size: int, mesh, axis: str, path: str, dim: int,
           report: ShardingReport | None):
    """axis if divisible else None (+ report the fallback)."""
    if _fits(size, mesh, axis):
        return axis
    if report is not None and _axis_size(mesh, axis) > 1:
        report.fallback(path, dim, size, axis, _axis_size(mesh, axis))
    return None


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------
def to_placements(spec: tuple, mesh) -> tuple:
    """One Placement per mesh dim for ``spec``.  A spec maps tensor dims to
    mesh axes; DTensor maps mesh dims to tensor dims, so this inverts it:
    a dim sharded over ``("pod", "data")`` is ``Shard(d)`` on both mesh
    dims, split in mesh order (pod major), as JAX splits it.  Axes that no
    dim names, and axes of size 1 (which split nothing), are
    ``Replicate()``.  DTensor always splits a dim in mesh
    order, so a dim whose axes are listed out of mesh order (the batch-1
    long-context cache's ``("model", "data")``) gets the same shard sizes
    as in JAX, with its blocks dealt to the ranks in another order; the
    global tensor is the same."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for i in (names.index(a) for a in axes):
            if sizes[i] == 1:  # an axis of one rank splits nothing
                continue
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 f"shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def distribute(x, sharding: NamedSharding):
    """``x`` (the same full tensor on every rank, or a meta tensor) as a
    DTensor laid out per ``sharding``: each rank keeps its own shard of its
    own copy, so nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def distribute_from_host(x: torch.Tensor, sharding: NamedSharding,
                         device) -> Any:
    """``x`` (a whole leaf in host memory, the same on every rank) as a
    DTensor laid out per ``sharding`` on ``device``: each rank copies only
    its own shard to the device, so no device holds the whole leaf (the
    reference's ``jax.device_put`` of a host array onto a sharding)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    placements = sharding.placements
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, sharding.mesh, placements)
    local = x[tuple(slice(o, o + n) for o, n in zip(offset, shape))].to(
        device, copy=True, memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sharding.mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def rows_only(x) -> bool:
    """A DTensor split, if at all, on its dim 0 (batch rows, token
    groups) only."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    return isinstance(x, DTensor) and all(
        p == Shard(0) or p == Replicate() for p in x.placements)


def local_rows(fn, rows: list, weights: list, n_out: int = 1,
               scalar_out: bool = False):
    """``fn(*local_rows, *whole_weights)`` through ``local_map``: the
    counterpart, for a computation whose rows are independent, of what
    GSPMD does to it with the batch sharded and the weights ZeRO-3
    sharded.  ``rows`` (DTensors split on dim 0 alone, the first one's
    split for all) keep their split; ``weights`` are gathered whole on
    every rank (an all-gather of their shards) and take their gradients
    as partial sums over the row split (reduce-scattered back onto their
    shards).  The ``n_out`` outputs are split like the first row input or,
    with ``scalar_out``, are partial sums over the split (a rank's sums
    over its own rows)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lead = rows[0]
    mesh = lead.device_mesh
    split = [p == Shard(0) for p in lead.placements]
    rep = [Replicate()] * mesh.ndim
    part = [Partial() if s else Replicate() for s in split]
    out = part if scalar_out else [Shard(0) if s else Replicate()
                                   for s in split]
    row_pl = tuple([Shard(0) if s else Replicate() for s in split]
                   for _ in rows)
    return local_map(
        fn, out_placements=out if n_out == 1 else (out,) * n_out,
        in_placements=row_pl + (rep,) * len(weights),
        in_grad_placements=row_pl + (part,) * len(weights),
        device_mesh=mesh, redistribute_inputs=True)(*rows, *weights)


def rows_like(x, lead):
    """A plain tensor ``x`` (the same on every rank, e.g. positions or a
    validity mask, indexed like ``lead``'s rows) as a DTensor split like
    the DTensor ``lead`` on dim 0, so that ``local_rows`` hands each rank
    its rows."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    pls = [Shard(0) if p == Shard(0) else Replicate()
           for p in lead.placements]
    return distribute_tensor(x, lead.device_mesh, pls, src_data_rank=None)


# ---------------------------------------------------------------------------
# per-parameter rules
# ---------------------------------------------------------------------------
def spec_for_param(path: str, shape: tuple[int, ...], cfg: ModelConfig,
                   mesh, report: ShardingReport | None = None) -> tuple:
    """Spec for one parameter leaf, identified by its tree path.

    ``path`` is '/'-joined (e.g. ``stages/0/attn/wq``).  Leading stacked-layer
    axes are never sharded.
    """
    name = path.rsplit("/", 1)[-1]
    parent = path.rsplit("/", 2)[-2] if "/" in path else ""
    nd = len(shape)

    def m(i: int, axis: str):
        return _maybe(shape[i], mesh, axis, path, i, report)

    def lead(k: int) -> tuple:
        return (None,) * (nd - k)

    # ---- embeddings / head -------------------------------------------------
    if name == "embed":  # (V, d): vocab->model (TP), d->data (FSDP)
        return (m(0, "model"), m(1, "data"))
    if name == "head":  # (d, V)
        return (m(0, "data"), m(1, "model"))

    # ---- MoE ---------------------------------------------------------------
    if parent == "moe":
        if name == "router":  # (L, d, E): E stays whole (routing is local)
            return lead(2) + (m(nd - 2, "data"), None)
        if name in ("wi", "wg"):  # (L, E, d, ff): EP on experts, FSDP on d
            return lead(3) + (m(nd - 3, "model"), m(nd - 2, "data"), None)
        if name == "wo":  # (L, E, ff, d)
            return lead(3) + (m(nd - 3, "model"), None, m(nd - 1, "data"))

    # ---- attention ---------------------------------------------------------
    if parent == "attn":
        if name in ("wq", "wk", "wv"):  # (L, d, H*hd): heads->model, d->data
            return lead(2) + (m(nd - 2, "data"), m(nd - 1, "model"))
        if name == "wo":  # (L, H*hd, d)
            return lead(2) + (m(nd - 2, "model"), m(nd - 1, "data"))
        if name in ("bq", "bk", "bv"):  # (L, H*hd)
            return lead(1) + (m(nd - 1, "model"),)

    # ---- dense MLP (also arctic's dense residual) --------------------------
    if parent in ("mlp", "dense_mlp"):
        if name in ("wi", "wg"):  # (L, d, ff)
            return lead(2) + (m(nd - 2, "data"), m(nd - 1, "model"))
        if name == "wo":  # (L, ff, d)
            return lead(2) + (m(nd - 2, "model"), m(nd - 1, "data"))

    # ---- SSM (Mamba-2) ------------------------------------------------------
    if parent == "ssm":
        if name == "in_proj":  # (L, d, 2di+2N+nh)
            return lead(2) + (m(nd - 2, "data"), m(nd - 1, "model"))
        if name == "out_proj":  # (L, di, d)
            return lead(2) + (m(nd - 2, "model"), m(nd - 1, "data"))
        if name in ("conv_w", "conv_b", "norm_w"):  # channel dim last
            return lead(1) + (m(nd - 1, "model"),)

    # ---- everything else (norms, scalars, A_log, D, dt_bias, betas) --------
    return (None,) * nd


def make_param_shardings(cfg: ModelConfig, mesh, params: Any,
                         report: ShardingReport | None = None):
    """Tree of :class:`NamedSharding` matching ``params`` (tensors of any
    device, ``meta`` included)."""

    def leaf(path, x):
        spec = spec_for_param(path, tuple(x.shape), cfg, mesh, report)
        if report is not None:
            report.note(path, spec)
        return NamedSharding(mesh, spec)

    return tree.map_with_path(leaf, params)


# ---------------------------------------------------------------------------
# parallelism plan + batch / cache shardings
# ---------------------------------------------------------------------------
def plan_parallelism(cfg: ModelConfig) -> str:
    """Per-arch parallelism mode over the fixed (pod, data, model) mesh.

      tp   — >=20B dense: activations replicated over ``model``; ff/head/vocab
             dims TP-sharded.
      ep   — MoE: experts on ``model``, batch ALSO on ``model`` (each rank
             holds a token group and an expert shard; dispatch is the
             all-to-all class GShard expects).
      fsdp — small dense/SSM: batch over every axis; weights stay sharded
             (ZeRO-3) and are all-gathered per layer.
    """
    if cfg.is_moe:
        return "ep"
    return "tp" if cfg.param_count() >= 20e9 else "fsdp"


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _batch_spec(batch: int, mesh, report: ShardingReport | None,
                what: str, mode: str = "tp") -> Any:
    """First candidate axis-tuple (by preference) that divides ``batch``."""
    has_pod = "pod" in mesh.mesh_dim_names
    if mode in ("fsdp", "ep"):
        cands = [("pod", "data", "model"), ("pod", "data"),
                 ("data", "model"), ("data",)]
    else:
        cands = [("pod", "data"), ("data",)]
    if not has_pod:
        cands = [tuple(a for a in c if a != "pod") for c in cands]
        cands = [c for i, c in enumerate(cands) if c and c not in cands[:i]]
    for axes in cands:
        total = 1
        for a in axes:
            total *= _axis_size(mesh, a)
        if batch % total == 0:
            if report is not None and axes != cands[0]:
                report.fallbacks.append(
                    f"{what}: batch {batch} %% {cands[0]} != 0 -> {axes}")
            return axes if len(axes) > 1 else axes[0]
    if report is not None:
        report.fallback(what, 0, batch, "data", _axis_size(mesh, "data"))
    return None


def make_batch_sharding(cfg: ModelConfig, mesh, shape: ShapeSpec,
                        report: ShardingReport | None = None) -> NamedSharding:
    """Sharding for a [global_batch, seq] token (or label) tensor."""
    mode = plan_parallelism(cfg)
    b = _batch_spec(shape.global_batch, mesh, report, f"batch[{shape.name}]",
                    mode)
    if b is None and shape.global_batch == 1 and shape.kind != "decode":
        # batch of one -> shard the *sequence* (SP); decode steps carry a
        # [B, 1] token whose length-1 seq dim cannot shard.
        seq_ax = "data" if _fits(shape.seq_len, mesh, "data") else None
        return NamedSharding(mesh, (None, seq_ax))
    return NamedSharding(mesh, (b, None))


def make_cache_shardings(cfg: ModelConfig, mesh, shape: ShapeSpec,
                         caches: Any,
                         report: ShardingReport | None = None):
    """Decode caches: batch -> ('pod','data'), heads/state -> 'model'.

    KV caches are [L, B, Hkv, W, hd]; SSM state is [L, B, nh, hd, N] and the
    conv state [L, B, K, C].  For batch-1 long-context decode the KV length
    dim W is sharded instead (sequence parallelism over the cache).
    """
    mode = plan_parallelism(cfg)
    b = _batch_spec(shape.global_batch, mesh, report, f"cache[{shape.name}]",
                    mode)
    used = set(b) if isinstance(b, tuple) else ({b} if b else set())

    def free(axis: str) -> bool:
        return axis not in used

    def leaf(p, x):
        nd = len(x.shape)
        spec = [None] * nd
        # layout convention: axis 0 = stacked layers, axis 1 = batch
        if nd >= 2:
            spec[1] = b
        name = p.rsplit("/", 1)[-1]
        if name in ("k", "v", "ks", "vs") and nd == 5:  # [L,B,Hkv,W,hd|1]
            if free("model") and _fits(x.shape[2], mesh, "model"):
                spec[2] = "model"
            else:
                # kv heads don't divide TP -> shard the cache *length* (SP)
                ax3 = []
                if free("model") and _fits(x.shape[3], mesh, "model"):
                    ax3.append("model")
                if b is None and _fits(x.shape[3] // (ax3 and
                        _axis_size(mesh, "model") or 1), mesh, "data"):
                    ax3.append("data")  # batch-1 long-context decode
                spec[3] = tuple(ax3) if len(ax3) > 1 else (ax3[0] if ax3 else None)
        elif name == "ssm" and nd == 5:  # SSM state [L,B,nh,P,N]
            if free("model"):
                spec[2] = _maybe(x.shape[2], mesh, "model", p, 2, report)
        elif name == "conv" and nd == 4:  # [L,B,K,C]
            if free("model"):
                spec[3] = _maybe(x.shape[3], mesh, "model", p, 3, report)
        spec = tuple(spec)
        if report is not None:
            report.note(p, spec)
        return NamedSharding(mesh, spec)

    return tree.map_with_path(leaf, caches)
