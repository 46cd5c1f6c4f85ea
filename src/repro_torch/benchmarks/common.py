"""Shared benchmark plumbing: CSV rows, cached simulation results, the
overlap gate's slack, a wall clock that waits for the card and a bitwise
comparison of logits."""
from __future__ import annotations

import functools
import os
import time

import torch

from repro_torch.core.cache_geometry import XEON_E5_35MB, XEON_45MB, XEON_60MB
from repro_torch.core.simulator import NetworkResult, simulate_network
from repro_torch.models.inception import inception_v3_specs


@functools.lru_cache(maxsize=None)
def sim(mb: int = 35) -> NetworkResult:
    geom = {35: XEON_E5_35MB, 45: XEON_45MB, 60: XEON_60MB}[mb]
    return simulate_network(inception_v3_specs(), geom)


def row(name: str, us_per_call: float, derived: str = "") -> str:
    return f"{name},{us_per_call:.4f},{derived}"


def overlap_wall_slack() -> float:
    """Allowed overlapped/serial wall ratio for the §IV-E double-buffer
    gate of ``sched_breakdown``: parity within noise on a single-core host
    (the prefetch and the compute timeslice one core, so total work is
    conserved), no loss where a second core exists (the reference's
    rule)."""
    return 1.0 if (os.cpu_count() or 1) > 1 else 1.25


def clock() -> float:
    """``time.perf_counter()`` after the card has finished the work queued
    so far (when CUDA is in use), so that a wall around device work
    measures the work and not its enqueue."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes and float32 bits (``-0.0`` and ``0.0`` differ)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def timed(fn, *args, iters: int = 3, **kw):
    """Wall-time a python callable: the *minimum* over ``iters`` calls
    after one warm call (the min is the stable estimate on a shared host).
    Each clock read waits for the card when CUDA is in use.  Returns
    ``(result, microseconds)``."""
    fn(*args, **kw)  # warm
    best = float("inf")
    for _ in range(iters):
        t0 = clock()
        out = fn(*args, **kw)
        best = min(best, clock() - t0)
    return out, best * 1e6
