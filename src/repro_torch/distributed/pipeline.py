"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (the port
of ``repro.distributed.pipeline``).

The stack-of-layers representation makes PP a reshape: stacked layer
params ``[L, ...]`` regroup to ``[S, L/S, ...]`` (:func:`split_stages`)
and each stage runs its sub-stack.  The schedule is the classic GPipe
fill/drain over microbatches:

  tick t: stage s computes microbatch (t - s) if 0 <= t - s < M, then
  passes its activation to stage s+1.  M + S - 1 ticks total; bubble
  fraction (S-1)/(M+S-1) — reported by :func:`bubble_fraction`.

Each rank of the ``stage`` axis is one stage; activations move by
``torch.distributed`` point-to-point (``batch_isend_irecv``, the
reference's ``ppermute``), and the last stage's outputs reach every stage
by a broadcast (the reference's masked ``psum``).  A stage computes only
its active ticks, so the outputs are bit-equal to the unpipelined stack.
It runs on any process group: gloo ranks on the CPU, or NCCL ranks, one
card each.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import tree

__all__ = ["gpipe_apply", "bubble_fraction", "split_stages"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def split_stages(stacked_params, n_stages: int):
    """[L, ...] leaves -> [S, L/S, ...] (the PP regrouping)."""

    def leaf(x):
        L = x.shape[0]
        assert L % n_stages == 0, f"{L} layers % {n_stages} stages"
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])

    return tree.map(leaf, stacked_params)


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def gpipe_apply(stage_fn: Callable, params_staged, x_mb, mesh,
                axis: str = "stage"):
    """Run the GPipe schedule.

    stage_fn(stage_params, x) -> y       (one stage's layers; y like x)
    params_staged: leaves [S, ...], full on every rank or DTensors sharded
                   ``Shard(0)`` over ``axis`` (each rank keeps its stage)
    x_mb: [M, mb, ...] microbatched input, the same on every rank
    Returns [M, mb, ...] outputs of the last stage, on every rank.
    """
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    prev = dist.get_global_rank(group, sid - 1) if sid > 0 else None
    nxt = dist.get_global_rank(group, sid + 1) if sid < S - 1 else None
    last = dist.get_global_rank(group, S - 1)

    params_local = tree.map(
        lambda p: _local(p)[0] if hasattr(p, "to_local") else p[sid],
        params_staged)
    x_all = _local(x_mb)
    M = x_all.shape[0]
    outs = torch.zeros_like(x_all)
    inbuf = torch.empty_like(x_all[0])
    for t in range(M + S - 1):
        mb = t - sid
        if 0 <= mb < M:
            y = stage_fn(params_local, x_all[t] if sid == 0 else inbuf)
            if sid == S - 1:
                outs[mb] = y
        ops = []
        if nxt is not None and 0 <= mb < M:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if prev is not None and 0 <= t - (sid - 1) < M:
            inbuf = torch.empty_like(x_all[0])
            ops.append(dist.P2POp(dist.irecv, inbuf, prev, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    # every stage holds `outs`, only the last stage's is real: share it
    dist.broadcast(outs, src=last, group=group)
    return outs
