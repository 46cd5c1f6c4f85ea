"""Traffic replay: the multi-engine orchestrator under 10^5+ requests.

The paper's throughput story scales by adding sockets (§VI-C/VI-D); this
bench replays seeded arrival traces — Poisson and bursty — through a
heterogeneous three-socket fleet behind ``launch/orchestrator.py`` and
GATES the routing claim: the latency-model router ("latency") must beat
the latency-blind baseline ("round-robin") on SLO hit rate, on BOTH
traces, or this module RAISES.

Fleet (``engine_api.SimulatedEngine`` over compressed full-Inception
plans — real ``LatencyModel``/``AdmissionPolicy`` code paths, fake-clock
execution; the times are modeled, not measured):

=============  ======================  ==========  ====================
socket         geometry                true_scale  modeled s/img (b=1)
=============  ======================  ==========  ====================
socket-35MB    XEON_E5_35MB (14 sl)    1.00        ~0.0047 (cap 2)
socket-17MB    scaled(7)               1.25        ~0.0070 (cap 1)
socket-10MB    scaled(4)               1.60        ~0.0104 (cap 1)
=============  ======================  ==========  ====================

The 10 MB socket cannot meet the 12 ms deadline even unloaded (p99 ~21 ms
once calibrated) — round-robin still sends it a third of the singles;
the latency router prices it out and only uses it as a deadline-blown
floor.  Every quantity is seeded (traces, per-engine jitter), so the
rows are deterministic and equal the reference's.

A second, real-execution segment (:func:`_real_fleet_bitidentity`)
routes images through three real ``NCServingEngine`` sockets on
``device`` (default ``cuda``) behind the same orchestrator and RAISES
unless every completed request's logits are byte-identical to a
standalone ``nc_forward`` (or to logits the caller passes) — the router
changes placement, never results.

``run_quick()`` replays a short Poisson trace through both routers with
the same gates.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.common import clock, row, same_bits
from repro_torch.core import schedule as nc_schedule
from repro_torch.core.cache_geometry import XEON_E5_35MB
from repro_torch.device import resolve_device
from repro_torch.launch.engine_api import SimRequest, SimulatedEngine
from repro_torch.launch.orchestrator import Orchestrator
from repro_torch.launch.serve import NCRequest, NCServingEngine
from repro_torch.models import inception

SLO_MS = 12.0
POISSON_RATE_HZ = 180.0
BURSTY_RATE_HZ = 120.0
JITTER = 0.05

# fleet: (name, slice scale of XEON_E5_35MB, true wall / modeled time)
FLEET_SPEC = [
    ("socket-35MB", 14, 1.00),
    ("socket-17MB", 7, 1.25),
    ("socket-10MB", 4, 1.60),
]


def make_fleet(jitter: float = JITTER):
    """Three heterogeneous simulated sockets over compressed plans."""
    specs = inception.inception_v3_specs()

    def schedule_for(geom):
        cache: dict = {}

        def f(n):
            if n not in cache:
                cache[n] = nc_schedule.plan_network(specs, geom, batch=n,
                                                    compressed=True)
            return cache[n]
        return f

    fleet = []
    for i, (name, n_slices, scale) in enumerate(FLEET_SPEC):
        geom = (XEON_E5_35MB if n_slices == XEON_E5_35MB.n_slices
                else XEON_E5_35MB.scaled(n_slices, name))
        fleet.append(SimulatedEngine(name, schedule_for(geom), max_batch=4,
                                     true_scale=scale, jitter=jitter,
                                     seed=100 + i))
    return fleet


def make_poisson_trace(n: int, rate_hz: float, seed: int) -> list[float]:
    """``n`` seeded Poisson arrival timestamps at ``rate_hz``."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_hz, size=n)).tolist()


def make_bursty_trace(n: int, rate_hz: float, seed: int, *,
                      burst: float = 2.5, lull: float = 0.3,
                      period_s: float = 2.0) -> list[float]:
    """On/off-modulated Poisson: alternating ``period_s`` phases at
    ``burst`` x and ``lull`` x the mean rate — queues build during bursts
    and drain during lulls."""
    rng = np.random.default_rng(seed)
    out: list[float] = []
    t = 0.0
    while len(out) < n:
        phase = burst if (int(t / period_s) % 2 == 0) else lull
        t += float(rng.exponential(1.0 / (rate_hz * phase)))
        out.append(t)
    return out


def replay(trace, router: str, *, slo_ms: float = SLO_MS,
           fleet=None):
    """Event-loop one arrival trace through an orchestrated fleet on a
    fake clock; returns the drained :class:`Orchestrator`.

    The clock jumps to the next event: the next arrival, the next
    engine-free instant, or — only while a free engine exists and the
    router is holding — a short recheck tick so holds release on time.
    """
    engines = make_fleet() if fleet is None else fleet
    clock_ = {"t": 0.0}
    orch = Orchestrator(engines, slo_ms=slo_ms, router=router,
                        now_fn=lambda: clock_["t"])
    i, n = 0, len(trace)
    hold_tick = (slo_ms / 1e3) / 8.0
    while i < n or orch.pending:
        while orch.step(now=clock_["t"], flush=(i >= n)):
            pass
        cands = []
        if i < n:
            cands.append(trace[i])
        nxt = orch.next_event_s(clock_["t"])
        if nxt > clock_["t"]:
            cands.append(nxt)
        if orch.queue and any(e.ready_in(clock_["t"]) <= 0.0
                              and e.queue_depth == 0
                              for e in orch.engines):
            # a free engine + a held queue: wake soon to release the hold
            cands.append(clock_["t"] + hold_tick)
        if not cands:
            break
        clock_["t"] = max(clock_["t"], min(cands))
        while i < n and trace[i] <= clock_["t"]:
            orch.submit(SimRequest(rid=i), now=trace[i])
            i += 1
    return orch


def _check_accounting(orch, n: int, label: str) -> None:
    """The serving accounting identities, fleet-wide — RAISES on
    violation."""
    s = orch.stats()
    if s["completed"] + s["failed"] != n:
        raise RuntimeError(f"{label}: {s['completed']} completed + "
                           f"{s['failed']} failed != {n} submitted")
    if s["slo_hits"] + s["slo_misses"] != s["completed"] + s["failed"]:
        raise RuntimeError(f"{label}: slo_hits {s['slo_hits']} + slo_misses "
                           f"{s['slo_misses']} != completed + failed")
    if orch.pending:
        raise RuntimeError(f"{label}: {orch.pending} requests stranded")
    batches = sum(s["batch_histogram"].values())
    admitted = sum(n_ * c for n_, c in s["batch_histogram"].items())
    if admitted != s["completed"] + s["failed"]:
        raise RuntimeError(f"{label}: histogram admits {admitted} != "
                           f"{s['completed'] + s['failed']} finished "
                           f"({batches} batches)")


def _replay_pair(trace_name: str, trace) -> tuple[list[str], dict]:
    """Replay one trace through both routers; gate latency > round-robin."""
    out = []
    rates = {}
    for router in ("latency", "round-robin"):
        orch = replay(trace, router)
        _check_accounting(orch, len(trace), f"{trace_name}/{router}")
        s = orch.stats()
        rates[router] = s["slo_hit_rate"]
        mean_us = float(np.mean([r.latency_s for r in orch.completed])) * 1e6
        tag = router.replace("-", "_")
        out.append(row(f"replay/{trace_name}_{tag}", mean_us,
                       f"hit_rate {s['slo_hit_rate']:.4f}; "
                       f"dispatched {s['dispatched']}"))
    if rates["latency"] <= rates["round-robin"]:
        raise RuntimeError(
            f"{trace_name}: latency router hit rate {rates['latency']:.4f} "
            f"does not beat round-robin {rates['round-robin']:.4f} — the "
            f"calibrated-curve routing rule regressed")
    return out, rates


def _real_fleet_bitidentity(params=None, config=None, images=None,
                            reference_logits=None, *, device=None,
                            stats=None) -> str:
    """Route ``images`` through three real ``NCServingEngine`` sockets on
    ``device`` (default ``cuda``) and RAISE unless every logit row is
    byte-identical to ``reference_logits[rid]`` or, when none are given,
    to a standalone ``nc_forward`` — whichever socket served it.
    ``stats``, when given, receives the orchestrator's ``stats()`` and
    ``forwards``, the batches each socket ran by name.

    By default the reference's tiny stem config
    (``reduced_config(img=47, width_div=8, classes=8, stages=())``) with
    seeded weights and 6 seeded images."""
    dev = resolve_device(device)
    cfg = config or inception.reduced_config(img=47, width_div=8, classes=8,
                                             stages=())
    if params is None:
        params = inception.init_params(torch.Generator().manual_seed(0),
                                       config=cfg, device=dev)
    if images is None:
        rng = np.random.default_rng(0)
        images = rng.uniform(size=(6, cfg.img, cfg.img, 3)).astype(np.float32)
    fake = {"t": 0.0}
    engines = [
        NCServingEngine(params, cfg, max_batch=2, geom=geom, name=name,
                        now_fn=lambda: fake["t"], device=dev)
        for name, geom in [
            ("socket-35MB", XEON_E5_35MB),
            ("socket-17MB", XEON_E5_35MB.scaled(7, "xeon-17MB")),
            ("socket-10MB", XEON_E5_35MB.scaled(4, "xeon-10MB")),
        ]
    ]
    orch = Orchestrator(engines, slo_ms=1e7, now_fn=lambda: fake["t"])
    t0 = clock()
    for i, img in enumerate(images):
        orch.submit(NCRequest(rid=i, image=img), now=float(i))
        fake["t"] = float(i)
    fake["t"] = float(len(images))
    orch.run()
    wall_us = (clock() - t0) * 1e6
    _check_accounting(orch, len(images), "real-fleet")
    what = ("the reference logits" if reference_logits is not None
            else "standalone nc_forward")
    for r in orch.completed:
        ref = (reference_logits[r.rid] if reference_logits is not None
               else inception.nc_forward(params, images[r.rid], config=cfg,
                                         device=dev)[0])
        if not same_bits(r.logits, torch.as_tensor(ref).to(r.logits.device)):
            raise RuntimeError(f"real-fleet: request {r.rid} logits differ "
                               f"from {what}")
    if stats is not None:
        stats.update(orch.stats(), forwards={
            e.name: sum(e.batch_histogram.values()) for e in engines})
    served = {n: c for n, c in orch.dispatched.items() if c}
    return row("replay/real_fleet_bitident", wall_us,
               f"{len(images)} imgs byte-identical across {len(served)} "
               f"real sockets")


def run(*, device=None) -> list[str]:
    """Both gated replays (60,000 Poisson and 40,000 bursty requests, two
    routers each, host only) and the real fleet on ``device``."""
    out = []
    poisson = make_poisson_trace(60_000, POISSON_RATE_HZ, seed=1)
    bursty = make_bursty_trace(40_000, BURSTY_RATE_HZ, seed=2)
    # >= 1e5 requests per router across the two gated traces
    rows, p_rates = _replay_pair("poisson", poisson)
    out.extend(rows)
    rows, b_rates = _replay_pair("bursty", bursty)
    out.extend(rows)
    out.append(row("replay/gate", 0.0,
                   f"latency beats round-robin: poisson "
                   f"{p_rates['latency']:.4f} > {p_rates['round-robin']:.4f}, "
                   f"bursty {b_rates['latency']:.4f} > "
                   f"{b_rates['round-robin']:.4f}"))
    out.append(_real_fleet_bitidentity(device=device))
    return out


def run_quick() -> list[str]:
    """A short Poisson trace through both routers with the same
    accounting and router gates as the full replay (host only)."""
    trace = make_poisson_trace(500, POISSON_RATE_HZ, seed=1)
    rates = {}
    us = 0.0
    for router in ("latency", "round-robin"):
        orch = replay(trace, router)
        _check_accounting(orch, len(trace), f"quick/{router}")
        rates[router] = orch.stats()["slo_hit_rate"]
        if router == "latency":
            us = float(np.mean([r.latency_s for r in orch.completed])) * 1e6
    if rates["latency"] <= rates["round-robin"]:
        raise RuntimeError(
            f"quick: latency router hit rate {rates['latency']:.4f} "
            f"does not beat round-robin {rates['round-robin']:.4f}")
    return [row("replay/quick_poisson", us,
                "mean latency, latency router; gates router + accounting")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="only the short Poisson replay (host, < 1 s)")
    ap.add_argument("--device", default="cuda",
                    help="the real fleet's device: cuda (default) needs a "
                         "GPU; cpu runs without one")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("\n".join(run_quick() if args.quick else run(device=dev)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
