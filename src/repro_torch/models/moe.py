"""Mixture-of-Experts layer (the port of ``repro.models.moe``): GShard-style
einsum dispatch (default) and a gather/scatter alternative, both
capacity-based with top-k renormalization.

Tokens are grouped (``moe_group_size``), routed in float32 to their top-k
experts, and placed first come, first served (in (token, choice) order
within a group) into per-expert buffers of ``_capacity`` rows; a choice
past its expert's capacity is dropped.  ``cfg.moe_impl`` picks the
implementation: ``einsum`` builds one-hot dispatch and combine tensors,
``scatter`` adds each kept token into its buffer row (an overflow row ``C``
takes the dropped ones) and gathers the results back.

The reference's expert-parallel sharding constraints (``_ep_axes``,
``_constrain_ep``) anchor the dispatch layout on a device mesh; on one GPU
there is no mesh, so they have no counterpart here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

__all__ = ["moe_init", "moe_apply", "moe_apply_einsum", "moe_apply_scatter"]

_F32 = torch.float32


def moe_init(cfg: ModelConfig, generator, device=None,
             out: dict | None = None) -> dict:
    """Router ``[d, E]`` (float32) and stacked SwiGLU experts ``wi``/``wg``
    ``[E, d, ff]`` and ``wo`` ``[E, ff, d]`` (``cfg.dtype``), drawn from
    ``generator`` with the reference's distributions (normal / sqrt(fan
    in)).  Each expert is drawn in float32 on its own and cast into place,
    so a layer's experts never exist in float32 at once; ``out`` (views of
    preallocated leaves) receives them in place, else they are allocated
    on ``device``."""
    dt = cfg.jdtype
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    if out is None:
        out = {"router": torch.empty((d, E), dtype=_F32, device=device),
               "wi": torch.empty((E, d, ff), dtype=dt, device=device),
               "wg": torch.empty((E, d, ff), dtype=dt, device=device),
               "wo": torch.empty((E, ff, d), dtype=dt, device=device)}
    out["router"].copy_(dense_init(generator, d, E, _F32, device))
    for name, fan_in in (("wi", d), ("wg", d), ("wo", ff)):
        leaf = out[name]
        for e in range(E):
            w = torch.randn(tuple(leaf.shape[1:]), generator=generator,
                            dtype=_F32, device=leaf.device)
            leaf[e] = (w / math.sqrt(fan_in)).to(dt)
    return out


def _router(cfg: ModelConfig, p: dict, x):
    """x: [..., d] -> probs [..., E] in float32."""
    return torch.softmax(x.to(_F32) @ p["router"], dim=-1)


def _topk(probs, k: int):
    """(weights [..., k], indices [..., k]), the weights renormalized over
    the top k.  Ties go to the lower expert index, as ``jax.lax.top_k``
    breaks them: a stable descending sort, not ``torch.topk``, which makes
    no such promise."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :k], idx[..., :k]
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return w, idx


def _expert_ffn(cfg: ModelConfig, p: dict, xe):
    """xe: [G, E, C, d] -> [G, E, C, d] through each expert's SwiGLU."""
    h = torch.einsum("gecd,edf->gecf", xe, p["wi"])
    g = torch.einsum("gecd,edf->gecf", xe, p["wg"])
    return torch.einsum("gecf,efd->gecd", F.silu(g) * h, p["wo"])


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts)
    return max(c, cfg.top_k)


def _group(cfg: ModelConfig, x):
    """[B, T, d] -> ([G, S, d], valid [G, S], S, G, ungroup).  Pads to whole
    groups; padded slots are masked out of routing and take no capacity."""
    B, T, d = x.shape
    flat = x.reshape(B * T, d)
    S = min(cfg.moe_group_size, B * T)
    pad = (-(B * T)) % S
    if pad:
        flat = F.pad(flat, (0, 0, 0, pad))
    G = flat.shape[0] // S
    valid = (torch.arange(G * S, device=x.device) < B * T).reshape(G, S)

    def ungroup(y):
        return y.reshape(G * S, d)[:B * T].reshape(B, T, d)

    return flat.reshape(G, S, d), valid, S, G, ungroup


def moe_apply_einsum(cfg: ModelConfig, p: dict, x):
    """GShard dense-dispatch MoE.  x: [B, T, d] -> [B, T, d]."""
    E, K = cfg.n_experts, cfg.top_k
    xg, valid, S, G, ungroup = _group(cfg, x)
    C = _capacity(cfg, S)

    probs = _router(cfg, p, xg)  # [G, S, E]
    w, idx = _topk(probs, K)  # [G, S, K]
    vf = valid.to(_F32)
    w = w * vf[..., None]

    # position of each (token, choice) in its expert's capacity buffer
    onehot = F.one_hot(idx, E).to(_F32) * vf[..., None, None]  # [G,S,K,E]
    flat = onehot.reshape(G, S * K, E)
    pos = torch.cumsum(flat, dim=1) - 1.0
    pos = (pos * flat).sum(dim=-1).reshape(G, S, K)
    keep = pos < C
    w = torch.where(keep, w, 0.0)

    # dispatch / combine tensors [G, S, E, C]; a dropped choice points at
    # row C, which one_hot over C + 1 classes then cuts off
    slot = torch.where(keep, pos, float(C)).to(torch.int64)
    pos_oh = F.one_hot(slot, C + 1)[..., :C].to(_F32)  # [G, S, K, C]
    dispatch = torch.einsum("gske,gskc->gsec", onehot, pos_oh)
    combine = torch.einsum("gske,gskc,gsk->gsec", onehot, pos_oh, w)

    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    ye = _expert_ffn(cfg, p, xe)
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)
    return ungroup(y)


def moe_apply_scatter(cfg: ModelConfig, p: dict, x):
    """Gather/scatter MoE: no dispatch-einsum FLOPs.  x: [B, T, d]."""
    E, K = cfg.n_experts, cfg.top_k
    d = x.shape[-1]
    xg, valid, S, G, ungroup = _group(cfg, x)
    C = _capacity(cfg, S)

    probs = _router(cfg, p, xg)
    w, idx = _topk(probs, K)  # [G, S, K]
    w = w * valid.to(_F32)[..., None]

    flat_e = idx.reshape(G, S * K)
    flat_valid = valid.repeat_interleave(K, dim=1)  # [G, S*K]
    onehot = F.one_hot(flat_e, E) * flat_valid[..., None]
    pos = torch.cumsum(onehot, dim=1) - 1
    pos = torch.gather(pos, -1, flat_e[..., None])[..., 0]  # [G, S*K]
    keep = (pos < C) & flat_valid
    pos_c = torch.where(keep, pos, C)  # row C = overflow bin

    xr = xg.repeat_interleave(K, dim=1)  # [G, S*K, d], one row per choice
    rows = torch.arange(G, device=x.device)[:, None].expand(G, S * K)
    buf = torch.zeros((G, E, C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((rows, flat_e, pos_c), xr, accumulate=True)
    ye = _expert_ffn(cfg, p, buf[:, :, :C])  # [G, E, C, d]
    ye = F.pad(ye, (0, 0, 0, 1))
    out = ye[rows, flat_e, pos_c]  # [G, S*K, d]
    out = out * torch.where(keep, w.reshape(G, S * K),
                            0.0)[..., None].to(x.dtype)
    y = out.reshape(G, S, K, d).sum(dim=2)
    return ungroup(y)


def moe_apply(cfg: ModelConfig, p: dict, x):
    if cfg.moe_impl == "scatter":
        return moe_apply_scatter(cfg, p, x)
    return moe_apply_einsum(cfg, p, x)
