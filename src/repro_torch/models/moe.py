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

EP sharding: the expert axis of the stacked expert weights maps to the
``model`` mesh axis; token groups ride the batch axes.  On a mesh
(``cfg.act_spec`` set, DTensor operands) :func:`_constrain_ep` lays the
expert-major buffers out groups x batch axes, experts x ``model``, so the
dispatch is an all-to-all-class exchange of tokens, as the reference
anchors it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.layers import dense_init

__all__ = ["moe_init", "moe_apply", "moe_apply_einsum", "moe_apply_scatter"]

_F32 = torch.float32


def _ep_axes(cfg: ModelConfig):
    """(group_axes, expert_axis) for EP sharding constraints, from
    ``cfg.act_spec``.  Groups ride the non-expert batch axes; experts ride
    'model'.  None when unconstrained (tests, one device)."""
    if cfg.act_spec is None:
        return None, None
    b = cfg.act_spec[0]
    flat = b if isinstance(b, tuple) else ((b,) if b else ())
    if "model" not in flat:
        return None, None
    g = tuple(a for a in flat if a != "model") or None
    return g, "model"


def _constrain_ep(cfg: ModelConfig, xe):
    """xe: [G, E, C, d] expert-major buffer -> groups x data, experts x
    model: anchors the all-to-all dispatch layout (without it the stacked
    expert weights may be gathered instead of the tokens exchanged)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import to_placements

    g, e = _ep_axes(cfg)
    if e is None or not isinstance(xe, DTensor):
        return xe
    mesh = cfg.act_spec[3]
    return xe.redistribute(mesh, to_placements((g, e, None, None), mesh))


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
    if is_dtensor(xe):
        return _local_experts(cfg, p, xe)
    h = torch.einsum("gecd,edf->gecf", xe, p["wi"])
    g = torch.einsum("gecd,edf->gecf", xe, p["wg"])
    return torch.einsum("gecf,efd->gecd", F.silu(g) * h, p["wo"])



def _local_experts(cfg: ModelConfig, p: dict, xe):
    """:func:`_expert_ffn` of a DTensor buffer on each rank's shard through
    ``local_map``: a mesh dim that splits the groups (dim 0) keeps them
    split, one that splits the experts (dim 1) splits the expert weights
    the same way, every other dim is replicated (the weights' FSDP split
    is gathered).  The weights' gradients are partial sums over the group
    split.  Groups and experts are independent, so this is exact."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xe.device_mesh
    x_pl, w_pl, g_pl = [], [], []
    for pl in xe.placements:
        if pl == Shard(0):
            x_pl.append(Shard(0)), w_pl.append(Replicate())
            g_pl.append(Partial())
        elif pl == Shard(1):
            x_pl.append(Shard(1)), w_pl.append(Shard(0))
            g_pl.append(Shard(0))
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate())
            g_pl.append(Replicate())
    names = ("wi", "wg", "wo")
    fn = local_map(lambda x, *ws: _expert_ffn(cfg, dict(zip(names, ws)), x),
                   out_placements=x_pl,
                   in_placements=(x_pl,) + (w_pl,) * 3,
                   in_grad_placements=(x_pl,) + (g_pl,) * 3,
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(xe, *(p[n] for n in names))


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts)
    return max(c, cfg.top_k)


def _whole_groups(flat, G: int):
    """A DTensor ``flat`` [G * S, d] whose token split maps onto whole
    groups: each mesh dim splitting the tokens keeps its split while the
    split counts divide G, the rest are gathered (DTensor cannot view a
    split dim into a group dim with fewer entries than shards)."""
    from torch.distributed.tensor import Replicate, Shard

    n, pls = 1, []
    for i, pl in enumerate(flat.placements):
        if pl == Shard(0):
            if G % (n * flat.device_mesh.size(i)) == 0:
                n *= flat.device_mesh.size(i)
            else:
                pl = Replicate()
        pls.append(pl)
    return flat.redistribute(flat.device_mesh, pls)


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
    if is_dtensor(flat):
        flat = _whole_groups(flat, G)
    valid = (torch.arange(G * S, device=x.device) < B * T).reshape(G, S)

    def ungroup(y):
        return y.reshape(G * S, d)[:B * T].reshape(B, T, d)

    return flat.reshape(G, S, d), valid, S, G, ungroup


def _dispatch_einsum(cfg: ModelConfig, router, xg, valid, C: int):
    """Route the groups ``xg`` [G, S, d] (``valid`` [G, S]) to their top-k
    experts' capacity buffers: (xe [G, E, C, d], combine [G, S, E, C])."""
    E, K = cfg.n_experts, cfg.top_k
    G, S = valid.shape
    probs = _router(cfg, {"router": router}, xg)  # [G, S, E]
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
    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(xg.dtype), xg)
    return xe, combine


def _combine_einsum(combine, ye):
    """Expert outputs ``ye`` [G, E, C, d] back to the groups' tokens."""
    return torch.einsum("gsec,gecd->gsd", combine.to(ye.dtype), ye)


def moe_apply_einsum(cfg: ModelConfig, p: dict, x):
    """GShard dense-dispatch MoE.  x: [B, T, d] -> [B, T, d].

    On a mesh (DTensor ``x``) the routing and dispatch, and the combine,
    run on each rank's token groups (``local_rows``: the router gathered
    whole), the expert-major buffers move to the experts' shards and back
    through :func:`_constrain_ep` (the all-to-all), and the experts run on
    their shards (:func:`_local_experts`)."""
    xg, valid, S, G, ungroup = _group(cfg, x)
    C = _capacity(cfg, S)
    if is_dtensor(xg):
        from repro_torch.distributed.sharding import local_rows, rows_like

        xe, combine = local_rows(
            lambda xl, vl, r: _dispatch_einsum(cfg, r, xl, vl, C),
            [xg, rows_like(valid, xg)], [p["router"]], 2)
        xe = _constrain_ep(cfg, xe)  # all-to-all: tokens to their experts
        ye = _constrain_ep(cfg, _expert_ffn(cfg, p, xe))
        return ungroup(local_rows(_combine_einsum, [combine, ye], []))
    xe, combine = _dispatch_einsum(cfg, p["router"], xg, valid, C)
    ye = _expert_ffn(cfg, p, xe)
    return ungroup(_combine_einsum(combine, ye))


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
    xe = _constrain_ep(cfg, buf[:, :, :C])
    ye = _constrain_ep(cfg, _expert_ffn(cfg, p, xe))  # [G, E, C, d]
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
