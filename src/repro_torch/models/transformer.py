"""Decoder LM assembly (the port of ``repro.models.transformer``).

Layers are grouped into *stages* (``plan_stages``) exactly as in the
reference, and each stage's parameters and caches keep the reference's
stacked layout: every leaf carries a leading layer axis ``[L, ...]``.  A
Python loop over the layers takes the place of ``jax.lax.scan``.  This
slice runs ``family == "dense"`` with ``frontend == "none"``; the other
families raise ``NotImplementedError``.

Entry points:
    init_lm(cfg, generator, device=...)          -> params
    params_from_jax(params_np, device=...)       -> params
    lm_apply(cfg, params, tokens, ...)           -> (hidden, caches or None)
    prefill(cfg, params, tokens, max_len=...)    -> (last_logits, caches)
    decode_step(cfg, params, tokens, caches, pos) -> (logits, caches)

Caches are written in place and returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

__all__ = ["plan_stages", "init_lm", "params_from_jax", "lm_apply",
           "lm_logits", "prefill", "decode_step", "init_caches", "Stage"]

_FAMILIES_ITEM = ("ROADMAP Queue 1 (the MoE, SSM, hybrid and frontend "
                  "families of the LM path)")


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


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with frontend "
            f"{cfg.frontend!r} is not ported yet; it waits for "
            f"{_FAMILIES_ITEM}")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _layer_init(cfg: ModelConfig, generator, device) -> dict:
    p: dict[str, Any] = {"norm1": L.norm_init(cfg, device),
                         "attn": L.attention_init(cfg, generator, device)}
    if cfg.d_ff > 0:
        p["norm2"] = L.norm_init(cfg, device)
        p["mlp"] = L.mlp_init(cfg, generator, device=device)
    return p


def _stack_into(dst: dict, i: int, leaf: dict) -> None:
    for name, v in leaf.items():
        if isinstance(v, dict):
            _stack_into(dst[name], i, v)
        else:
            dst[name][i] = v


def _empty_stacked(leaf: dict, n: int) -> dict:
    return {name: (_empty_stacked(v, n) if isinstance(v, dict)
                   else v.new_empty((n,) + tuple(v.shape)))
            for name, v in leaf.items()}


def init_lm(cfg: ModelConfig, generator: torch.Generator, *,
            device: str | torch.device | None = None) -> dict:
    """Seeded random parameters on ``device`` (default ``"cuda"``), drawn
    from ``generator`` (a ``torch.Generator`` on that device) with the
    reference's distributions: weights normal / sqrt(d_in), embeddings
    normal x 0.02, norms 1, biases 0, each drawn in float32 and cast to
    ``cfg.dtype``.  Layers are drawn one at a time into the stacked leaves,
    so the float32 draw of one layer is the only temporary."""
    _check_family(cfg)
    dev = resolve_device(device)
    stage_params = []
    for st in plan_stages(cfg):
        stacked = None
        for i in range(st.length):
            one = _layer_init(cfg, generator, dev)
            if stacked is None:
                stacked = _empty_stacked(one, st.length)
            _stack_into(stacked, i, one)
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
    """Per-stage stacked caches ``{"attn": {"k", "v"}}`` of
    ``[L, batch, Hkv, seq_len, hd]`` zeros on ``device`` (default
    ``"cuda"``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    caches = []
    for st in plan_stages(cfg):
        one = L.attention_cache_init(cfg, batch, seq_len, st.window, dev)
        caches.append({"attn": {k: v.new_zeros((st.length,) + tuple(v.shape))
                                for k, v in one.items()}})
    return caches


# ---------------------------------------------------------------------------
# layers and the model
# ---------------------------------------------------------------------------
def _index(tree: dict, i: int) -> dict:
    return {k: (_index(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _layer_apply(cfg, lp, x, positions, window, attn_cache, cache_pos):
    h = L.apply_norm(cfg, lp["norm1"], x)
    a, _ = L.attention_apply(cfg, lp["attn"], h, positions, window=window,
                             cache=attn_cache, cache_pos=cache_pos)
    x = x + a
    if cfg.d_ff > 0:
        x = x + L.mlp_apply(cfg, lp["mlp"],
                            L.apply_norm(cfg, lp["norm2"], x))
    return x


def _stage_apply(cfg, stacked, x, positions, window, cache, cache_pos):
    """Run the stacked layers of one stage in order (the reference's scan);
    the stage's cache, if any, is written in place."""
    for i in range(stacked["attn"]["wq"].shape[0]):
        ac = _index(cache["attn"], i) if cache is not None else None
        x = _layer_apply(cfg, _index(stacked, i), x, positions, window, ac,
                         cache_pos)
    return x, cache


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
    _check_family(cfg)
    x = _embed(cfg, params, tokens, embeds)
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)
    for si, st in enumerate(plan_stages(cfg)):
        cache = caches[si] if caches is not None else None
        x, _ = _stage_apply(cfg, params["stages"][si], x, positions,
                            st.window, cache, cache_pos)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return x, caches


def lm_logits(cfg, params, hidden):
    return _head(cfg, params, hidden)


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
