"""Decoder LM assembly (the port of ``repro.models.transformer``).

Layers are grouped into *stages* (``plan_stages``) exactly as in the
reference, and each stage's parameters and caches keep the reference's
stacked layout: every leaf carries a leading layer axis ``[L, ...]``.  A
Python loop over the layers takes the place of ``jax.lax.scan``.  The
dense, audio and vision families run the dense backbone (the audio and
vision frontends are stubs, ``models/frontends.py``: a ``vision_patch``
prefill takes ``embeds``); the MoE family replaces the MLP with
``models/moe.py``'s layer (plus arctic's parallel dense MLP,
``moe_dense_residual``); the SSM family's layers are Mamba-2 mixers
(``models/mamba2.py``) and the hybrid family's run attention and the mixer
in parallel, with sliding-window (ring-cache) attention outside the global
layers.

Entry points:
    init_lm(cfg, generator, device=...)          -> params
    params_from_jax(params_np, device=...)       -> params
    lm_apply(cfg, params, tokens, ...)           -> (hidden, caches or None)
    lm_loss(cfg, params, tokens, labels, ...)    -> scalar loss
    prefill(cfg, params, tokens, max_len=...)    -> (last_logits, caches)
    decode_step(cfg, params, tokens, caches, pos) -> (logits, caches)

Caches are written in place and returned: the attention layers write
their slots, and the mixers' new ``conv`` and ``ssm`` state is copied into
the stacked leaves.

Sharded over a mesh (parameters, caches and inputs as DTensors,
:func:`repro_torch.launch.steps.build_sharded_step`), ``cfg.act_spec`` is
``(batch_axes, seq_axes, vocab_axis, mesh)`` and :func:`_constrain` /
:func:`_sp_enter` re-lay the activations out at the reference's anchor
points; with ``act_spec`` None, or on plain tensors, they return their
input unchanged.  Where the activations (and the layer's caches) are split
on the batch alone and the layers' rows are independent (every family but
MoE, whose token groups span rows), the layers run on each rank's rows
with plain ops through ``local_map``: a training stage as one
``local_map`` whose layers each all-gather their weights inside their
remat region and reduce-scatter the gradients (ZeRO-3, as GSPMD plans
the FSDP mode; :func:`_local_stage`), a layer with caches as one
(:func:`_local_layer`); the embedding gather and each loss chunk likewise
(:func:`repro_torch.distributed.sharding.local_rows`).  The values are
those of DTensor's op-by-op plan; the host dispatches a handful of DTensor
ops a stage instead of each of its ops (on one card the op-by-op plan
doubled the olmo-1b train step's wall).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (is_dtensor, local_rows,
                                              rows_like, rows_only,
                                              to_placements)
from repro_torch.distributed.trace_analysis import note_loop
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MoE

__all__ = ["plan_stages", "init_lm", "params_from_jax", "lm_apply",
           "lm_logits", "lm_loss", "prefill", "decode_step", "init_caches",
           "Stage"]


@dataclasses.dataclass(frozen=True)
class Stage:
    start: int
    length: int
    window: int  # 0 = full attention


def plan_stages(cfg: ModelConfig) -> list[Stage]:
    if not cfg.global_layers or cfg.attn_window == 0:
        return [Stage(0, cfg.n_layers, cfg.attn_window)]
    stages: list[Stage] = []
    i = 0
    globals_ = set(cfg.global_layers)
    while i < cfg.n_layers:
        if i in globals_:
            stages.append(Stage(i, 1, 0))
            i += 1
        else:
            j = i
            while j < cfg.n_layers and j not in globals_:
                j += 1
            stages.append(Stage(i, j - i, cfg.attn_window))
            i = j
    return stages


# ---------------------------------------------------------------------------
# activation sharding constraints (the reference's GSPMD anchor points)
# ---------------------------------------------------------------------------
def _relayout(x, spec: tuple, mesh):
    """``x`` redistributed to ``spec`` on ``mesh`` if it is a DTensor."""
    if not is_dtensor(x):
        return x
    return x.redistribute(mesh, to_placements(spec, mesh))


@functools.lru_cache(maxsize=16)
def _unsharded(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, act_spec=None)


def _local_layer(cfg, lp, x, positions, window, cache, cache_pos):
    """:func:`_layer_apply` on each rank's rows (see the module
    docstring); ``cache`` (the layer's views, split on the batch alone) is
    written in place through its local shards."""
    wl, wdef = tree.flatten(lp)
    cl, cdef = tree.flatten(cache)
    pos_rows = rows_like(positions, x) if positions.ndim > 1 else None
    lcfg = _unsharded(cfg)

    def fn(xl, *rest):
        i = 0
        pl = positions
        if pos_rows is not None:
            pl, i = rest[0], 1
        c = tree.unflatten(cdef, rest[i:i + len(cl)])
        w = tree.unflatten(wdef, rest[i + len(cl):])
        return _layer_apply(lcfg, w, xl, pl, window, c, cache_pos)

    rows = [x] + ([pos_rows] if pos_rows is not None else []) + cl
    return local_rows(fn, rows, wl)


def _gathered(t, placements, mesh):
    """One layer's slice ``t`` of a stacked leaf's local shard, gathered
    whole: an all-gather (whose backward reduce-scatters the gradient)
    over each mesh dim that splits it, on the dim it splits (one less
    than the stacked leaf's, whose layer axis is never split)."""
    import torch.distributed._functional_collectives as funcol

    # the name of torch 2.13 (older releases: all_gather_tensor_autograd)
    gather = getattr(funcol, "all_gather_single_autograd", None) \
        or funcol.all_gather_tensor_autograd
    for i, p in enumerate(placements):
        if p.is_shard():
            t = gather(t, gather_dim=p.dim - 1, group=(mesh, i))
    return t


def _local_stage(cfg, stacked, x, positions, st: Stage):
    """A training stage's layers on each rank's rows in one ``local_map``
    (see the module docstring): the stacked leaves enter as local shards,
    each layer gathers its slice whole inside its remat region (so the
    backward gathers it again, as ZeRO-3 does) and reduce-scatters its
    gradient, and the weights' gradients are partial sums over the row
    split elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    wl, wdef = tree.flatten(stacked)
    pls = [tuple(w.placements) for w in wl]
    split = [p == Shard(0) for p in x.placements]
    grad_pls = tuple([p if p.is_shard() else (Partial() if s_ else Replicate())
                      for p, s_ in zip(wp, split)] for wp in pls)
    lcfg = _unsharded(cfg)

    def layer(c, lp, h, pos, window, cache, cache_pos):
        full = tree.unflatten(wdef, [_gathered(t, pl, mesh) for t, pl in
                                     zip(tree.leaves(lp), pls)])
        return _layer_apply(c, full, h, pos, window, cache, cache_pos)

    layer = _remat_wrap(lcfg, layer)

    def fn(xl, *ws):
        for lp in _unbind(tree.unflatten(wdef, ws), st.length):
            xl = layer(lcfg, lp, xl, positions, st.window, None, None)
        return xl

    return local_map(fn, out_placements=list(x.placements),
                     in_placements=(list(x.placements),)
                     + tuple(list(p) for p in pls),
                     in_grad_placements=(list(x.placements),) + grad_pls,
                     device_mesh=mesh)(x, *wl)


def _stage_is_local(cfg, stacked, x) -> bool:
    """A training stage whose layers run in one ``local_map``: rows-only
    activations, and every stacked leaf a DTensor split only on mesh dims
    that also split the rows (its gathers' reduce-scatters then sum the
    rows' gradient contributions once each)."""
    from torch.distributed.tensor import Shard

    if not _layer_is_rowwise(cfg, x, None):
        return False
    split = [p == Shard(0) for p in x.placements]
    return all(is_dtensor(w) and w.device_mesh == x.device_mesh and all(
        p.is_replicate() or (p.is_shard() and p.dim > 0 and s_)
        for p, s_ in zip(w.placements, split))
        for w in tree.leaves(stacked))


def _layer_is_rowwise(cfg, x, cache) -> bool:
    return (cfg.act_spec is not None and not cfg.is_moe
            and not cfg.megatron_sp and rows_only(x)
            and all(rows_only(c) for c in tree.leaves(cache or {})))


def _act_layout(cfg: ModelConfig, kind: str) -> tuple:
    """The spec ``_constrain`` lays an activation of ``kind`` out by."""
    b, s, v, mesh = cfg.act_spec
    if kind == "act":  # [B, T, d]
        return (b, s, None)
    if kind in ("loss_h", "logits"):
        # Loss region: trade sequence parallelism for vocab TP (see the
        # reference): h to (batch, -, -), the logits to (batch, -, model).
        if not cfg.loss_vocab_tp:  # baseline: loss follows the act sharding
            return (b, s, None if kind == "loss_h" else v)
        v_eff = v
        if v is None and s == "model":
            n = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get(
                "model", 1)
            if n > 1 and cfg.vocab_size % n == 0:
                v_eff = "model"
        return (b, None, None) if kind == "loss_h" else (b, None, v_eff)
    return (b, s)  # [B, T]


def _constrain(cfg: ModelConfig, x, kind: str = "act"):
    """Re-anchor activation sharding at layer boundaries, so that one
    op's layout choice cannot leave the residual stream replicated.
    ``cfg.act_spec`` is set by ``build_sharded_step``; None (tests, one
    device) is a no-op.
    """
    if cfg.act_spec is None:
        return x
    return _relayout(x, _act_layout(cfg, kind), cfg.act_spec[3])


def _sp_enter(cfg, h):
    """Megatron-SP block entry: all-gather the seq-sharded residual so the
    block's GEMMs see full sequences and the weights stay sharded.  The
    residual stream stays seq-sharded between blocks; only the transient
    block input is gathered."""
    if cfg.act_spec is None or not cfg.megatron_sp:
        return h
    b, s, _, mesh = cfg.act_spec
    if s is None:
        return h
    return _relayout(h, (b, None, None), mesh)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _layer_init(cfg: ModelConfig, generator, device,
                out: dict | None = None) -> dict:
    """One layer's parameters or, given ``out`` (the layer's views of the
    stacked leaves), the same draws written into it: the MoE experts drawn
    in place, one expert at a time, every other (smaller) leaf drawn whole
    and copied into its slot.  Returns the layer's tree."""
    def put(name, leaf):
        if out is None:
            return leaf
        if isinstance(leaf, dict):
            _copy_into(out[name], leaf)
        else:
            out[name].copy_(leaf)
        return out[name]

    p: dict[str, Any] = {"norm1": put("norm1", L.norm_init(cfg, device))}
    if cfg.has_attention:
        p["attn"] = put("attn", L.attention_init(cfg, generator, device))
    if cfg.has_ssm:
        p["ssm"] = put("ssm", M.mamba_init(cfg, generator, device))
    if cfg.family == "hybrid":
        for name in ("beta_attn", "beta_ssm"):
            p[name] = put(name, torch.ones((), dtype=torch.float32,
                                           device=device))
    if cfg.is_moe:
        p["norm2"] = put("norm2", L.norm_init(cfg, device))
        p["moe"] = MoE.moe_init(cfg, generator, device,
                                out=None if out is None else out["moe"])
        if cfg.moe_dense_residual:
            p["dense_mlp"] = put("dense_mlp", L.mlp_init(
                cfg, generator, d_ff=cfg.dense_ff or 2 * cfg.d_model,
                device=device))
    elif cfg.d_ff > 0:
        p["norm2"] = put("norm2", L.norm_init(cfg, device))
        p["mlp"] = put("mlp", L.mlp_init(cfg, generator, device=device))
    return p


def _copy_into(dst: dict, src: dict) -> None:
    for name, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[name], v)
        else:
            dst[name].copy_(v)


def _empty_stacked(leaf: dict, n: int, device) -> dict:
    return {name: (_empty_stacked(v, n, device) if isinstance(v, dict)
                   else torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                                    device=device))
            for name, v in leaf.items()}


def init_lm(cfg: ModelConfig, generator: torch.Generator, *,
            device: str | torch.device | None = None) -> dict:
    """Seeded random parameters on ``device`` (default ``"cuda"``), drawn
    from ``generator`` (a ``torch.Generator`` on that device) with the
    reference's distributions: weights normal / sqrt(d_in), embeddings
    normal x 0.02, norms 1, biases 0, each drawn in float32 and cast to
    ``cfg.dtype``.  The stacked leaves are allocated first (their shapes
    from a ``meta``-device layer) and each layer is drawn into them; the
    MoE experts are drawn into them in place, one expert at a time.  So the
    temporaries are one layer's other leaves and one leaf's (one expert's)
    float32 draw, and a model that fills most of the device is never built
    twice.  Each leaf keeps the layer's dtype: the mixers' ``A_log``, ``D``
    and ``dt_bias`` and the hybrid's ``beta_attn``/``beta_ssm`` (stacked to
    ``[L]``) are float32."""
    dev = resolve_device(device)
    template = _layer_init(cfg, None, torch.device("meta"))
    stage_params = []
    for st in plan_stages(cfg):
        stacked = _empty_stacked(template, st.length, dev)
        for i in range(st.length):
            _layer_init(cfg, generator, dev, out=_index(stacked, i))
        stage_params.append(stacked)
    params = {
        "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model,
                              cfg.jdtype, dev),
        "stages": stage_params,
        "final_norm": L.norm_init(cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                      cfg.jdtype, dev)
    return params


def _to_torch(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy's bfloat16 has no torch twin
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def params_from_jax(params_np, *, device: str | torch.device | None = None):
    """The reference's LM parameter tree (dicts and lists of
    numpy-convertible arrays) as the port's tensors on ``device`` (default
    ``"cuda"``), keeping each leaf's dtype and shape."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return _to_torch(x, dev)

    return conv(params_np)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *,
                device: str | torch.device | None = None) -> list[dict]:
    """Per-stage stacked caches, every leaf ``[L, batch, ...]`` zeros on
    ``device`` (default ``"cuda"``): ``{"attn": {"k", "v"}}`` (plus
    ``"ks"``, ``"vs"`` for the int8 cache) of ``seq_len`` slots, or of
    ``min(window, seq_len)`` ring slots in a sliding-window stage, and for
    the SSM and hybrid families ``{"ssm": {"conv", "ssm"}}``."""
    dev = resolve_device(device)
    caches = []
    for st in plan_stages(cfg):
        c: dict[str, Any] = {}
        if cfg.has_attention:
            c["attn"] = L.attention_cache_init(cfg, batch, seq_len, st.window,
                                               dev)
        if cfg.has_ssm:
            c["ssm"] = M.mamba_cache_init(cfg, batch, dev)
        caches.append({kind: {k: v.new_zeros((st.length,) + tuple(v.shape))
                              for k, v in one.items()}
                       for kind, one in c.items()})
    return caches


# ---------------------------------------------------------------------------
# layers and the model
# ---------------------------------------------------------------------------
def _index(tree: dict, i: int) -> dict:
    return {k: (_index(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _mixer(cfg, p, h, cache):
    """The Mamba-2 mixer on h; given ``cache`` (the layer's views of the
    stacked ``conv``/``ssm`` leaves) its new state is copied into it.  A
    single token with a cache is a decode step (also a one-token prompt,
    on the zero cache, as in the reference)."""
    if h.shape[1] == 1 and cache is not None:
        s, new = M.mamba_step(cfg, p, h, cache)
    else:
        s, new = M.mamba_apply(cfg, p, h, cache=cache)
    if cache is not None:
        for name, val in new.items():
            cache[name].copy_(val)
    return s


def _layer_apply(cfg, lp, x, positions, window, cache, cache_pos):
    h = _sp_enter(cfg, L.apply_norm(cfg, lp["norm1"], x))
    cache = cache or {}
    if cfg.has_attention:
        a, _ = L.attention_apply(cfg, lp["attn"], h, positions, window=window,
                                 cache=cache.get("attn"), cache_pos=cache_pos)
    if cfg.has_ssm:
        s = _mixer(cfg, lp["ssm"], h, cache.get("ssm"))
    if cfg.family == "hybrid":
        ba = lp["beta_attn"].to(x.dtype)
        bs = lp["beta_ssm"].to(x.dtype)
        x = x + (ba * a + bs * s) / (ba + bs)
    else:
        x = x + (s if cfg.has_ssm else a)
    if cfg.is_moe:
        h2 = _sp_enter(cfg, L.apply_norm(cfg, lp["norm2"], x))
        y = MoE.moe_apply(cfg, lp["moe"], h2)
        if cfg.moe_dense_residual:
            y = y + L.mlp_apply(cfg, lp["dense_mlp"], h2)
        x = x + y
    elif cfg.d_ff > 0:
        x = x + L.mlp_apply(cfg, lp["mlp"],
                            _sp_enter(cfg, L.apply_norm(cfg, lp["norm2"], x)))
    return _constrain(cfg, x)


def _unbind(tree: dict, n: int) -> list[dict]:
    """The ``n`` per-layer views of a stacked tree, one ``unbind`` per
    leaf: its backward stacks the layers' gradients once, where a
    ``select`` per layer would build a zero tensor the size of the whole
    ``[L, ...]`` leaf for each layer."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind(v, n) if isinstance(v, dict) else v.unbind(0)
        for o, part in zip(out, parts):
            o[k] = part
    return out


def _remat_wrap(cfg, fn):
    """``cfg.remat``: ``"full"`` recomputes the whole layer in the
    backward; ``"dots"`` saves the weight products' outputs (``aten.mm``)
    and recomputes the rest, so the attention scores and probabilities
    (batched products) are not kept, as the reference's
    ``dots_with_no_batch_dims_saveable``.  Values are the same under every
    policy; only the memory held for the backward differs."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE
                    if op is torch.ops.aten.mm.default
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, policy))
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _stage_apply(cfg, stacked, x, positions, st: Stage, cache, cache_pos):
    """Run the ``st.length`` stacked layers of one stage in order (the
    reference's scan); the stage's cache, if any, is written in place.
    Without a cache (a training forward) each layer runs under
    :func:`_remat_wrap`: all of them in one ``local_map`` where
    :func:`_stage_is_local` holds, op by op through DTensor otherwise."""
    note_loop(f"stage[{st.start}:{st.start + st.length}]/layers", st.length)
    if cache is not None:
        for i in range(st.length):
            c = _index(cache, i)
            apply = (_local_layer if _layer_is_rowwise(cfg, x, c)
                     else _layer_apply)
            x = apply(cfg, _index(stacked, i), x, positions, st.window, c,
                      cache_pos)
        return x, cache
    if _stage_is_local(cfg, stacked, x):
        return _local_stage(cfg, stacked, x, positions, st), None
    layer = _remat_wrap(cfg, _layer_apply)
    for lp in _unbind(stacked, st.length):
        x = layer(cfg, lp, x, positions, st.window, None, cache_pos)
    return x, None


def _embed(cfg, params, tokens=None, embeds=None):
    if embeds is not None:
        return _constrain(cfg, embeds.to(cfg.jdtype))
    if cfg.act_spec is not None and rows_only(tokens):
        # each rank gathers its rows from the whole table
        return _constrain(cfg, local_rows(
            lambda t, e: e[t.to(torch.int64)], [tokens], [params["embed"]]))
    return _constrain(cfg, params["embed"][tokens.to(torch.int64)])


def _head(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ w


def lm_apply(cfg, params, tokens=None, *, embeds=None, positions=None,
             caches=None, cache_pos=None):
    """Backbone forward.  Returns (hidden [B,T,d], caches or None)."""
    x = _embed(cfg, params, tokens, embeds)
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)
    for si, st in enumerate(plan_stages(cfg)):
        cache = caches[si] if caches is not None else None
        x, _ = _stage_apply(cfg, params["stages"][si], x, positions, st,
                            cache, cache_pos)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return x, caches


def lm_logits(cfg, params, hidden):
    out = _head(cfg, params, hidden)
    if cfg.act_spec is not None and out.ndim == 2:
        b, _, v, mesh = cfg.act_spec
        out = _relayout(out, (b, v), mesh)
    return out


def _chunk_loss(cfg, params, h, lab):
    """Summed cross-entropy of one ``[B, C]`` chunk and its count of
    labels >= 0 (label -1 is padding).  On a mesh whose loss region is
    split on the batch alone, each rank sums its own rows (the sums are
    partial over the split)."""
    if cfg.act_spec is not None and _loss_is_rowwise(cfg, h, lab):
        w = params["embed"] if cfg.tie_embeddings else params["head"]
        key = "embed" if cfg.tie_embeddings else "head"
        lcfg = _unsharded(cfg)
        return local_rows(
            lambda hl, ll, wl: _chunk_loss(lcfg, {key: wl}, hl, ll),
            [h, lab], [w], 2, scalar_out=True)
    h = _constrain(cfg, h, "loss_h")
    logits = _head(cfg, params, h).to(getattr(torch, cfg.loss_dtype))
    logits = _constrain(cfg, logits, "logits")
    logz = torch.logsumexp(logits, dim=-1)
    gold = _gold_logits(logits, torch.clamp_min(lab, 0).to(torch.int64))
    valid = lab >= 0
    ce = torch.where(valid, logz - gold, 0.0)
    return ce.sum(dtype=torch.float32), valid.sum(dtype=torch.int32)


def _gold_logits(logits, lab):
    """``logits[..., lab]``.  Logits split on the vocab (a DTensor) pick
    the label as a masked sum over the vocab, each rank's slice giving its
    part: ``take_along_dim`` on a split vocab leaves a masked-partial gold
    that DTensor fails to reduce on a mesh of three dims.  One term of the
    sum is the label's logit and the others exact zeros, so both forms
    give the same bits and gradients."""
    if is_dtensor(logits) and any(p.is_shard(logits.ndim - 1)
                                  for p in logits.placements):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = logits.device_mesh
        vocab = DTensor.from_local(  # the same vocab index on every rank
            torch.arange(logits.shape[-1], device=logits.to_local().device),
            mesh, [Replicate()] * mesh.ndim, run_check=False)
        return torch.where(vocab == lab[..., None], logits, 0.0).sum(-1)
    return torch.take_along_dim(logits, lab[..., None], dim=-1)[..., 0]


def _loss_is_rowwise(cfg, h, lab) -> bool:
    """The loss region's layouts (``_constrain``'s "loss_h" and "logits")
    split nothing but the batch, and h and the labels are so split."""
    from torch.distributed.tensor import Shard

    mesh = cfg.act_spec[3]
    return (rows_only(h) and rows_only(lab) and all(
        p.is_replicate() or p == Shard(0)
        for kind in ("loss_h", "logits")
        for p in to_placements(_act_layout(cfg, kind), mesh)))


def lm_loss(cfg, params, tokens, labels, *, embeds=None,
            loss_chunk: int = 512):
    """Next-token cross-entropy over labels >= 0, chunked over the sequence
    so [B, S, V] never materializes: each ``loss_chunk`` of positions runs
    under a checkpoint that recomputes its logits in the backward instead
    of keeping them.  The float32 sum over the chunks is divided by the
    count of labels (at least 1)."""
    hidden, _ = lm_apply(cfg, params, tokens, embeds=embeds)
    B, T, D = hidden.shape
    C = min(loss_chunk, T)
    pad = (-T) % C
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for i in range(0, hidden.shape[1], C):
        ce, n = checkpoint(_chunk_loss, cfg, params, hidden[:, i:i + C],
                           labels[:, i:i + C], use_reentrant=False)
        tot, cnt = tot + ce, cnt + n
    return tot / torch.clamp_min(cnt, 1)


def prefill(cfg, params, tokens=None, *, embeds=None,
            max_len: int | None = None, caches=None):
    """Run the prompt, return (last-position logits [B,V], caches).

    ``max_len`` sets the KV-cache capacity (prompt + decode headroom); the
    caches are zeros on the parameters' device, or ``caches`` (zeros of
    that capacity, e.g. laid out on a mesh) when given."""
    if tokens is not None:
        batch, seq_len = tokens.shape
    else:
        batch, seq_len = embeds.shape[0], embeds.shape[1]
    if caches is None:
        caches = init_caches(cfg, batch, max_len or seq_len,
                             device=params["embed"].device)
    hidden, caches = lm_apply(cfg, params, tokens, embeds=embeds,
                              caches=caches)
    return lm_logits(cfg, params, hidden[:, -1]), caches


def decode_step(cfg, params, tokens, caches, pos):
    """One token for the whole batch.  tokens [B,1]; pos: scalar position
    shared by every row, or an int32 [B] vector of per-slot positions —
    continuous batching admits prompts of different lengths, so each slot
    decodes (RoPE) and writes KV at its OWN position."""
    dev = params["embed"].device
    if torch.as_tensor(pos).ndim > 0:
        pos = torch.as_tensor(pos, dtype=torch.int32).reshape(-1).to(dev)
        positions = pos[:, None]
    else:
        positions = torch.full((tokens.shape[0], 1), int(pos),
                               dtype=torch.int32, device=dev)
    hidden, caches = lm_apply(cfg, params, tokens, positions=positions,
                              caches=caches, cache_pos=pos)
    return lm_logits(cfg, params, hidden[:, 0]), caches
