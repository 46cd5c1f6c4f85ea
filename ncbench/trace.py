"""Reading the device trace of a traced window.

``torch.profiler`` records the device's activity (CUDA activity only: the
host side is read from the harness's own spans).  The events are read from
the profiler's raw results, without building its per-event Python tree.
A marker kernel launched on an idle device at a known host instant ties the
trace's clock to the host clock of the spans.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


@contextlib.contextmanager
def device_profile(device: torch.device):
    """Profile the device's activity while the context is open; yields a
    dict that holds ``events`` (start_ns, end_ns, names) and
    ``offset_ns`` (trace clock minus ``perf_counter_ns``) on exit."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    if device.type != "cuda":  # no device trace to read
        yield out
        out.update(starts=np.zeros(0, np.int64), ends=np.zeros(0, np.int64),
                   names=[], offset_ns=0)
        return
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize(device)
    t_mark = time.perf_counter_ns()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(device)
    try:
        yield out
    finally:
        torch.cuda.synchronize(device)
        prof.stop()
        starts, ends, names, mark = [], [], [], None
        cuda = torch._C._autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda or e.is_user_annotation():
                continue
            name = e.name()
            if mark is None and MARKER in name:
                mark = e.start_ns()
                continue
            starts.append(e.start_ns())
            ends.append(e.start_ns() + e.duration_ns())
            names.append(name)
        order = np.argsort(np.asarray(starts, dtype=np.int64), kind="stable")
        out["starts"] = np.asarray(starts, dtype=np.int64)[order]
        out["ends"] = np.asarray(ends, dtype=np.int64)[order]
        out["names"] = [names[i] for i in order]
        out["offset_ns"] = (mark - t_mark if mark is not None
                            else time.time_ns() - time.perf_counter_ns())
        del prof


def summarize(tr: dict, t0_ns: int, t1_ns: int, segments, top: int = 10):
    """Device figures over the host-clock window ``[t0_ns, t1_ns]``:
    ``busy_s`` (union of device activity), ``kernel_s`` (seconds by
    kernel name), ``device_ops`` (the ``top`` names by seconds) and
    ``idle_gaps`` (idle device seconds by the innermost host span open at
    the gap's middle, ``"window"`` outside every span)."""
    off = tr["offset_ns"]
    s = np.clip(tr["starts"] - off, t0_ns, t1_ns)
    e = np.clip(tr["ends"] - off, t0_ns, t1_ns)
    keep = e > s
    s, e = s[keep], e[keep]
    names = [n for n, k in zip(tr["names"], keep) if k]
    # union of the intervals (one stream runs them in order, but be exact)
    run_end = np.maximum.accumulate(e) if len(e) else e
    prev_end = np.concatenate([[t0_ns], run_end[:-1]]) if len(e) else e
    busy = float(np.sum(np.maximum(e - np.maximum(s, prev_end), 0))) / 1e9
    by_name = {}
    for n, d in zip(names, (e - s).tolist()):
        by_name[n] = by_name.get(n, 0) + d
    kernel_s = {n: d / 1e9 for n, d in by_name.items()}
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps: between the running end of activity and the next start
    gap_lo = np.concatenate([[t0_ns], run_end]) if len(e) else np.array([t0_ns])
    gap_hi = np.concatenate([s, [t1_ns]]) if len(e) else np.array([t1_ns])
    gaps = np.maximum(gap_hi - gap_lo, 0)
    mids = (gap_lo + gap_hi) // 2
    idle = {"window": 0}
    label = np.full(len(gaps), -1, dtype=np.int64)
    if segments:
        seg_lo = np.asarray([a for a, _, _ in segments], dtype=np.int64)
        seg_hi = np.asarray([b for _, b, _ in segments], dtype=np.int64)
        idx = np.searchsorted(seg_lo, mids, side="right") - 1
        inside = (idx >= 0) & (mids < seg_hi[np.maximum(idx, 0)])
        label = np.where(inside, idx, -1)
    per_seg = np.bincount(label + 1, weights=gaps,
                          minlength=len(segments) + 1)
    idle["window"] += int(per_seg[0])
    for (_, _, name), g in zip(segments, per_seg[1:].tolist()):
        idle[name] = idle.get(name, 0) + int(g)
    idle_gaps = sorted(((k, v / 1e9) for k, v in idle.items() if v > 0),
                       key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy, kernel_s=kernel_s,
                device_ops=[[n[:120], v] for n, v in ops],
                idle_gaps=[[k, v] for k, v in idle_gaps])
