"""AdamW with optional int8 moment state (the port of
``repro.optim.adamw``).

The quantized-moment option carries the paper's 8-bit theme into the
optimizer: m and v are stored as int8 with per-channel (last-axis) float32
scales, cutting the moments from 8 to about 2 bytes per parameter.

State layout: ``{"m": tuple, "v": tuple, "count": int32 tensor}``, the
moments aligned with :func:`repro_torch.tree.leaves` of the parameters
(JAX's leaf order), so the state is checkpoint-compatible with the
reference's.  Parameters, gradients and moments are plain tensors; an
update is computed in float32 and cast to the parameter's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch import tree

__all__ = ["AdamW", "adamw", "apply_updates", "cosine_schedule",
           "MomentState"]

_F32 = torch.float32


class MomentState(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device: CUDA divides a tensor by
    a Python number as a product with its reciprocal, which can differ in
    the last bit, so the divisor is a tensor on x's device."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _q8_pack(x: torch.Tensor) -> MomentState:
    """float32 -> int8 with per-channel (last-axis) float32 scales,
    shape-preserving, rounded half to even as ``jnp.round``.  A scalar
    keeps its value as the scale."""
    if x.ndim == 0:
        return MomentState(torch.zeros((), dtype=torch.int8, device=x.device),
                           x.to(_F32)[None])
    scale = _div(torch.amax(torch.abs(x), dim=-1, keepdim=True), 127.0)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return MomentState(q, scale.to(_F32))


def _q8_unpack(ms: MomentState, shape) -> torch.Tensor:
    if len(shape) == 0:
        return ms.scale[0]
    return ms.q.to(_F32) * ms.scale


def _moment_zero(p: torch.Tensor, quantized: bool):
    z = torch.zeros(p.shape, dtype=_F32, device=p.device)
    return _q8_pack(z) if quantized else z


def _pow(base: float, exponent: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.full((), base, dtype=_F32,
                                device=exponent.device), exponent)


def _sum_squares(leaves):
    total = 0
    for g in leaves:
        total = total + torch.sum(torch.square(g.to(_F32)))
    return total


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the float32 sum of squares over ``leaves``, summed leaf by
    leaf in order, as the reference's Python ``sum``.  DTensor leaves are
    summed on each rank's shards, one ``local_map`` for each layout (in
    the order the layouts first appear), the per-layout sums partial over
    the mesh dims that split them."""
    leaves = list(leaves)
    if leaves and all(_is_dtensor(g) for g in leaves):
        return torch.sqrt(_local_sum_squares(leaves))
    return torch.sqrt(torch.as_tensor(_sum_squares(leaves), dtype=_F32))


def _local_sum_squares(leaves):
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    groups: dict = {}
    for g in leaves:
        groups.setdefault((g.device_mesh, tuple(g.placements)), []).append(g)
    total = 0
    for (mesh, pls), gs in groups.items():
        out = [Partial() if p.is_shard() else Replicate() for p in pls]
        total = total + local_map(
            lambda *xs: _sum_squares(xs), out_placements=out,
            in_placements=(pls,) * len(gs), device_mesh=mesh)(*gs)
    return total


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False

    def init(self, params) -> dict:
        leaves = tree.leaves(params)
        dev = leaves[0].device if leaves else None
        return {
            "m": tuple(_moment_zero(p, self.quantize_moments)
                       for p in leaves),
            "v": tuple(_moment_zero(p, self.quantize_moments)
                       for p in leaves),
            "count": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def update(self, grads, state, params):
        """``(updates, new_state)``; ``updates`` has the grads' structure
        and each parameter's dtype."""
        count = state["count"] + 1
        lr = self.lr(count) if callable(self.lr) else self.lr

        g_leaves, treedef = tree.flatten(grads)
        p_leaves = tree.leaves(params)

        cscale = None
        if self.grad_clip > 0:
            gnorm = global_norm(g_leaves)
            clip = torch.full((), self.grad_clip, dtype=_F32,
                              device=gnorm.device)
            cscale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-12),
                                     1.0)

        cf = count.to(_F32)
        bc1 = 1.0 - _pow(self.b1, cf)
        bc2 = 1.0 - _pow(self.b2, cf)

        leaves = (g_leaves, list(state["m"]), list(state["v"]), p_leaves)
        moments = (self._local_moments if _same_layout(*leaves)
                   else self._moments)
        updates, new_m, new_v = moments((cscale, lr, bc1, bc2), *leaves)
        return (tree.unflatten(treedef, updates),
                {"m": tuple(new_m), "v": tuple(new_v), "count": count})

    def _moments(self, scalars, gs, ms, vs, ps):
        """Each leaf's clipped gradient, new moments and update."""
        cscale, lr, bc1, bc2 = scalars
        updates, new_m, new_v = [], [], []
        for g, m, v, p in zip(gs, ms, vs, ps):
            if cscale is not None:
                g = g * cscale.to(g.dtype)
            g = g.to(_F32)
            qm, qv = isinstance(m, MomentState), isinstance(v, MomentState)
            mf = _q8_unpack(m, g.shape) if qm else m
            vf = _q8_unpack(v, g.shape) if qv else v
            mf = self.b1 * mf + (1 - self.b1) * g
            vf = self.b2 * vf + (1 - self.b2) * torch.square(g)
            step = (mf / bc1) / (torch.sqrt(vf / bc2) + self.eps)
            step = step + self.weight_decay * p.to(_F32)
            updates.append((-lr * step).to(p.dtype))
            new_m.append(_q8_pack(mf) if qm else mf)
            new_v.append(_q8_pack(vf) if qv else vf)
        return updates, new_m, new_v

    def _local_moments(self, scalars, gs, ms, vs, ps):
        """:meth:`_moments` of DTensor leaves (each leaf's gradient, moments
        and parameter laid out alike) through one ``local_map``: the
        update is elementwise, so each rank updates its own shards; the
        clip scale and the schedule's scalars are whole on every rank."""
        from torch.distributed.tensor.experimental import local_map

        n = len(gs)
        flat = list(scalars) + gs + ms + vs + ps

        def fn(*xs):
            rest = xs[4:]
            u, m, v = self._moments(xs[:4], rest[:n], rest[n:2 * n],
                                    rest[2 * n:3 * n], rest[3 * n:])
            return tuple(u) + tuple(m) + tuple(v)

        out = local_map(
            fn, out_placements=tuple(x.placements for x in ps + ms + vs),
            in_placements=tuple(x.placements if _is_dtensor(x) else None
                                for x in flat),
            device_mesh=ps[0].device_mesh)(*flat)
        return list(out[:n]), list(out[n:2 * n]), list(out[2 * n:])


def _is_dtensor(x) -> bool:
    from repro_torch.distributed.sharding import is_dtensor

    return is_dtensor(x)


def _same_layout(gs, ms, vs, ps) -> bool:
    """DTensor leaves, float moments, each leaf's four laid out alike."""
    return bool(ps) and all(
        _is_dtensor(p) and not isinstance(m, MomentState)
        and all(_is_dtensor(x) and x.placements == p.placements
                and x.device_mesh == p.device_mesh for x in (g, m, v))
        for g, m, v, p in zip(gs, ms, vs, ps))


def adamw(**kw) -> AdamW:
    return AdamW(**kw)


def apply_updates(params, updates):
    return tree.map(lambda p, u: p + u.to(p.dtype), params, updates)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    def sched(count: torch.Tensor) -> torch.Tensor:
        c = count.to(_F32)
        warm = _div(c, max(warmup, 1))
        prog = torch.clamp(_div(c - warmup, max(total - warmup, 1)), 0.0,
                           1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak * torch.where(c < warmup, warm, cos)

    return sched
