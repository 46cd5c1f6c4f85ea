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

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
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
    h = L.apply_norm(cfg, lp["norm1"], x)
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
        h2 = L.apply_norm(cfg, lp["norm2"], x)
        y = MoE.moe_apply(cfg, lp["moe"], h2)
        if cfg.moe_dense_residual:
            y = y + L.mlp_apply(cfg, lp["dense_mlp"], h2)
        x = x + y
    elif cfg.d_ff > 0:
        x = x + L.mlp_apply(cfg, lp["mlp"],
                            L.apply_norm(cfg, lp["norm2"], x))
    return x


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
    :func:`_remat_wrap`."""
    if cache is not None:
        for i in range(st.length):
            x = _layer_apply(cfg, _index(stacked, i), x, positions,
                             st.window, _index(cache, i), cache_pos)
        return x, cache
    layer = _remat_wrap(cfg, _layer_apply)
    for lp in _unbind(stacked, st.length):
        x = layer(cfg, lp, x, positions, st.window, None, cache_pos)
    return x, None


def _embed(cfg, params, tokens=None, embeds=None):
    if embeds is not None:
        return embeds.to(cfg.jdtype)
    return params["embed"][tokens.to(torch.int64)]


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
    return _head(cfg, params, hidden)


def _chunk_loss(cfg, params, h, lab):
    """Summed cross-entropy of one ``[B, C]`` chunk and its count of
    labels >= 0 (label -1 is padding)."""
    logits = _head(cfg, params, h).to(getattr(torch, cfg.loss_dtype))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(
        logits, torch.clamp_min(lab, 0)[..., None].to(torch.int64),
        dim=-1)[..., 0]
    valid = lab >= 0
    ce = torch.where(valid, logz - gold, 0.0)
    return ce.sum(dtype=torch.float32), valid.sum(dtype=torch.int32)


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
            max_len: int | None = None):
    """Run the prompt, return (last-position logits [B,V], caches).

    ``max_len`` sets the KV-cache capacity (prompt + decode headroom); the
    caches live on the parameters' device."""
    if tokens is not None:
        batch, seq_len = tokens.shape
    else:
        batch, seq_len = embeds.shape[0], embeds.shape[1]
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
