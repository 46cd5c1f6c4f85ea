"""The port's ``SimulatedEngine`` and ``Orchestrator`` against the reference.

Every case of the reference's ``tests/test_orchestrator.py`` is driven
through both packages on the same fake clock: the routing decisions
(engine, admitted batch, target, budget, reason), the dispatch counts, the
fleet and per-engine stats and each request's latency must be equal, for
the latency router and for round robin, on simulated fleets with seeded
jitter and on seeded Poisson and bursty arrival traces.  The two-socket
real fleet of port ``NCServingEngine``s is held against two reference
engines with the forward's wall charged by a fake ``perf_counter`` (as in
``tests/test_torch_serve_slo.py``), and every routed logit row must be
byte-identical to a standalone port ``nc_forward``.

All quantities compared are host arithmetic on the same float64 inputs, so
equality is exact.
"""
import math
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import schedule as rsched
from repro.core.cache_geometry import XEON_E5_35MB as RGEOM
from repro.launch import engine_api as rapi
from repro.launch import orchestrator as rorch
from repro.launch import serve as rserve
from repro.models import inception as ri
from repro_torch.core import schedule as tsched
from repro_torch.core.cache_geometry import XEON_E5_35MB as TGEOM
from repro_torch.launch import engine_api as tapi
from repro_torch.launch import orchestrator as torch_orch
from repro_torch.launch import serve as tserve
from repro_torch.models import inception as ti

torch.set_num_threads(1)

PKGS = {
    "ref": types.SimpleNamespace(api=rapi, orch=rorch, sched=rsched,
                                 geom=RGEOM, inception=ri),
    "port": types.SimpleNamespace(api=tapi, orch=torch_orch, sched=tsched,
                                  geom=TGEOM, inception=ti),
}


@pytest.fixture(scope="module")
def sched_for():
    """``sched_for(pkg)(n_slices)(n)``: per-package, per-geometry plan
    caches over the full Inception specs (compressed plans)."""
    caches: dict = {}

    def for_pkg(name):
        pkg = PKGS[name]
        specs = pkg.inception.inception_v3_specs()

        def for_slices(n_slices):
            geom = (pkg.geom if n_slices == pkg.geom.n_slices
                    else pkg.geom.scaled(n_slices))
            cache = caches.setdefault((name, n_slices), {})

            def f(n):
                if n not in cache:
                    cache[n] = pkg.sched.plan_network(specs, geom, batch=n,
                                                      compressed=True)
                return cache[n]
            return f
        return for_slices
    return for_pkg


def _drain(orch, clock, tick=1e-4):
    guard = 0
    while orch.pending:
        while orch.step(now=clock["t"], flush=True):
            pass
        if not orch.pending:
            break
        nxt = orch.next_event_s(clock["t"])
        clock["t"] = nxt if nxt > clock["t"] else clock["t"] + tick
        guard += 1
        assert guard < 100_000, "fleet failed to drain"
    return orch


def _summary(orch):
    s = orch.stats()
    return dict(
        decisions=[(d.engine, d.admit, d.target,
                    None if math.isnan(d.budget_s) else d.budget_s, d.reason)
                    for d in orch.decisions],
        dispatched=dict(orch.dispatched),
        stats=s,
        latencies=sorted((r.rid, r.latency_s, r.slo_ok)
                         for r in orch.completed),
        engine_decisions={e.name: [(d.admit, d.target, d.reason)
                                   for d in getattr(e, "decisions", [])]
                          for e in orch.engines})


def _both(scenario, sched_for):
    """Run ``scenario(pkg, sched_for(pkg))`` for both packages; the
    summaries must be equal.  Returns the port's orchestrator and
    summary."""
    out = {}
    for name, pkg in PKGS.items():
        orch = scenario(pkg, sched_for(name))
        out[name] = (orch, _summary(orch))
    assert out["ref"][1] == out["port"][1]
    return out["port"]


# ---------------------------------------------------------------------------
# Engine API contract
# ---------------------------------------------------------------------------
def test_simulated_engine_implements_engine_api(sched_for):
    seen = {}
    for name, pkg in PKGS.items():
        e = pkg.api.SimulatedEngine("sock", sched_for(name)(14), max_batch=4)
        assert isinstance(e, pkg.api.Engine)
        assert e.queue_depth == 0 and e.ready_in(0.0) == 0.0
        assert e.batch_cap == min(4, e.latency_model.stream_batch_limit)
        e.submit(pkg.api.SimRequest(rid=0), now=0.0)
        assert e.step(now=0.0) is True
        assert e.busy_until > 0.0 and e.ready_in(0.0) > 0.0
        assert e.step(now=0.0) is False  # busy engines admit nothing
        assert e.queue_depth == 0 and len(e.completed) == 1
        assert e.completed[0].done and e.completed[0].latency_s > 0.0
        assert e.latency_model.samples == 1
        seen[name] = (e.batch_cap, e.busy_until, e.stats())
    assert seen["ref"] == seen["port"]


@pytest.mark.parametrize("slo_ms", [None, 20.0])
def test_simulated_engine_admission_with_jitter(sched_for, slo_ms):
    """One engine with its own SLO policy and seeded jitter: the jitter
    draws (numpy's generator, as the reference) and the admission
    decisions are equal request for request."""
    def scenario(pkg, sf):
        e = pkg.api.SimulatedEngine("sock", sf(14), max_batch=4,
                                    slo_ms=slo_ms, jitter=0.2, seed=11,
                                    true_scale=1.5)
        rng = np.random.default_rng(3)
        t = 0.0
        for i in range(60):
            t += float(rng.exponential(2e-3))
            e.submit(pkg.api.SimRequest(rid=i), now=t)
            e.step(now=t)
        while e.queue:
            t = max(t, e.busy_until)
            e.step(now=t, flush=True)
        return e

    got = {}
    for name, pkg in PKGS.items():
        e = scenario(pkg, sched_for(name))
        got[name] = (e.stats(), [(d.admit, d.target, d.reason)
                                 for d in e.decisions],
                     [r.latency_s for r in e.completed])
    assert got["ref"] == got["port"]
    assert got["port"][0]["completed"] == 60


def test_orchestrator_validates_fleet():
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="at least one"):
            pkg.orch.Orchestrator([])
        fake = [pkg.api.SimRequest(rid=0), pkg.api.SimRequest(rid=1)]
        for r in fake:
            r.name = "dup"
        with pytest.raises(ValueError, match="unique"):
            pkg.orch.Orchestrator(fake)
        fake[1].name = "other"
        with pytest.raises(ValueError, match="router"):
            pkg.orch.Orchestrator(fake, router="fastest")


# ---------------------------------------------------------------------------
# Calibration isolation + routing preference
# ---------------------------------------------------------------------------
def test_per_engine_calibration_isolation(sched_for):
    def scenario(pkg, sf):
        fast = pkg.api.SimulatedEngine("fast", sf(14), max_batch=2,
                                       true_scale=1.0)
        slow = pkg.api.SimulatedEngine("slow", sf(14), max_batch=2,
                                       true_scale=3.0)
        clock = {"t": 0.0}
        orch = pkg.orch.Orchestrator([fast, slow], now_fn=lambda: clock["t"])
        for i in range(8):
            orch.submit(pkg.api.SimRequest(rid=i), now=0.0)
        return _drain(orch, clock)

    orch, s = _both(scenario, sched_for)
    fast, slow = orch.engines
    assert s["stats"]["completed"] == 8 and orch.pending == 0
    assert fast.latency_model.scale == pytest.approx(1.0)
    assert slow.latency_model.scale == pytest.approx(3.0)
    assert fast.steps + slow.steps == sum(
        s["stats"]["batch_histogram"].values())


def test_latency_router_prefers_calibrated_faster_engine(sched_for):
    def scenario(pkg, sf):
        fast = pkg.api.SimulatedEngine("fast", sf(14), max_batch=1,
                                       true_scale=1.0)
        slow = pkg.api.SimulatedEngine("slow", sf(14), max_batch=1,
                                       true_scale=4.0)
        m = fast.latency_model.modeled_batch_s(1)
        for e in (fast, slow):
            e.latency_model.observe(1, e.true_scale * m)
        clock = {"t": 0.0}
        orch = pkg.orch.Orchestrator([fast, slow], slo_ms=100 * m * 1e3,
                                     now_fn=lambda: clock["t"])
        for i in range(5):
            t = i * 2.0 * m
            clock["t"] = t
            orch.submit(pkg.api.SimRequest(rid=i), now=t)
            orch.step(now=t)
        return _drain(orch, clock)

    orch, s = _both(scenario, sched_for)
    assert s["dispatched"] == {"fast": 5, "slow": 0}
    assert orch.slo_hits == 5 and orch.slo_misses == 0


def test_wait_better_holds_for_busy_fast_engine(sched_for):
    def scenario(pkg, sf):
        fast = pkg.api.SimulatedEngine("fast", sf(14), max_batch=1,
                                       true_scale=1.0)
        slow = pkg.api.SimulatedEngine("slow", sf(14), max_batch=1,
                                       true_scale=4.0)
        m = fast.latency_model.modeled_batch_s(1)
        for e in (fast, slow):
            e.latency_model.observe(1, e.true_scale * m)
        clock = {"t": 0.0}
        orch = pkg.orch.Orchestrator([fast, slow], slo_ms=3 * m * 1e3,
                                     now_fn=lambda: clock["t"])
        orch.submit(pkg.api.SimRequest(rid=0), now=0.0)
        assert orch.step(now=0.0)
        orch.submit(pkg.api.SimRequest(rid=1), now=0.0)
        assert orch.step(now=0.0) is False
        assert orch.decisions[-1].reason == "wait-better"
        clock["t"] = fast.busy_until
        assert orch.step(now=clock["t"])
        return _drain(orch, clock)

    orch, s = _both(scenario, sched_for)
    assert s["dispatched"] == {"fast": 2, "slow": 0}
    assert orch.slo_hits == 2 and orch.slo_misses == 0


def test_orchestrator_hold_bounded_by_arrival_rate(sched_for):
    def scenario(pkg, sf):
        eng = pkg.api.SimulatedEngine("sock", sf(14), max_batch=2,
                                      true_scale=1.0)
        eng.latency_model.observe(1, eng.latency_model.modeled_batch_s(1))
        m = eng.latency_model.modeled_batch_s(1)
        clock = {"t": 0.0}
        orch = pkg.orch.Orchestrator([eng], slo_ms=3 * m * 1e3,
                                     now_fn=lambda: clock["t"])
        orch.submit(pkg.api.SimRequest(rid=0), now=0.0)
        assert orch.step(now=0.0) is False
        orch.step(now=0.0, flush=True)
        clock["t"] = 40 * m
        orch.submit(pkg.api.SimRequest(rid=1), now=clock["t"])
        assert orch.step(now=clock["t"]) is True
        return _drain(orch, clock)

    orch, s = _both(scenario, sched_for)
    reasons = [d[-1] for d in s["decisions"]]
    assert reasons[0] == "hold" and "ragged-early" in reasons
    assert orch.pending == 0


# ---------------------------------------------------------------------------
# Round robin + drain accounting
# ---------------------------------------------------------------------------
def test_round_robin_cycles_free_engines(sched_for):
    def scenario(pkg, sf):
        engines = [pkg.api.SimulatedEngine(f"s{i}", sf(14), max_batch=2)
                   for i in range(3)]
        clock = {"t": 0.0}
        orch = pkg.orch.Orchestrator(engines, router="round-robin",
                                     now_fn=lambda: clock["t"])
        for i in range(6):
            orch.submit(pkg.api.SimRequest(rid=i), now=0.0)
        for _ in range(3):
            orch.step(now=0.0)
        assert orch.dispatched == {"s0": 1, "s1": 1, "s2": 1}
        return _drain(orch, clock)

    orch, s = _both(scenario, sched_for)
    assert all(d[-1] == "round-robin" for d in s["decisions"]
               if d[0] is not None)
    assert s["stats"]["completed"] == 6 and orch.pending == 0


@pytest.mark.parametrize("router", ["latency", "round-robin"])
def test_drain_flush_heterogeneous_fleet(sched_for, router):
    def scenario(pkg, sf):
        engines = [
            pkg.api.SimulatedEngine("socket-35MB", sf(14), max_batch=4,
                                    true_scale=1.0, jitter=0.05, seed=1),
            pkg.api.SimulatedEngine("socket-17MB", sf(7), max_batch=4,
                                    true_scale=1.25, jitter=0.05, seed=2),
            pkg.api.SimulatedEngine("socket-10MB", sf(4), max_batch=4,
                                    true_scale=1.6, jitter=0.05, seed=3),
        ]
        m = engines[0].latency_model.modeled_batch_s(1)
        clock = {"t": 0.0}
        orch = pkg.orch.Orchestrator(engines, slo_ms=3 * m * 1e3,
                                     router=router,
                                     now_fn=lambda: clock["t"])
        rng = np.random.default_rng(0)
        for i, t in enumerate(np.sort(rng.uniform(0.0, 5 * m, size=40))):
            clock["t"] = float(t)
            orch.submit(pkg.api.SimRequest(rid=i), now=float(t))
            orch.step(now=float(t))
        return _drain(orch, clock)

    orch, s = _both(scenario, sched_for)
    st = s["stats"]
    assert st["completed"] + st["failed"] == 40 and orch.pending == 0
    assert st["slo_hits"] + st["slo_misses"] == st["completed"] + st["failed"]
    assert sum(n * c for n, c in st["batch_histogram"].items()) == 40
    assert 0.0 <= st["slo_hit_rate"] <= 1.0


# ---------------------------------------------------------------------------
# Seeded traffic replays (benchmarks/traffic_replay.py's event loop)
# ---------------------------------------------------------------------------
SLO_MS = 12.0
FLEET_SPEC = [("socket-35MB", 14, 1.00), ("socket-17MB", 7, 1.25),
              ("socket-10MB", 4, 1.60)]


def _poisson(n, rate_hz, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_hz, size=n)).tolist()


def _bursty(n, rate_hz, seed, burst=2.5, lull=0.3, period_s=2.0):
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while len(out) < n:
        phase = burst if (int(t / period_s) % 2 == 0) else lull
        t += float(rng.exponential(1.0 / (rate_hz * phase)))
        out.append(t)
    return out


def _replay(pkg, sf, trace, router):
    engines = [pkg.api.SimulatedEngine(name, sf(n_slices), max_batch=4,
                                       true_scale=scale, jitter=0.05,
                                       seed=100 + i)
               for i, (name, n_slices, scale) in enumerate(FLEET_SPEC)]
    clock = {"t": 0.0}
    orch = pkg.orch.Orchestrator(engines, slo_ms=SLO_MS, router=router,
                                 now_fn=lambda: clock["t"])
    i, n = 0, len(trace)
    hold_tick = (SLO_MS / 1e3) / 8.0
    while i < n or orch.pending:
        while orch.step(now=clock["t"], flush=(i >= n)):
            pass
        cands = [trace[i]] if i < n else []
        nxt = orch.next_event_s(clock["t"])
        if nxt > clock["t"]:
            cands.append(nxt)
        if orch.queue and any(e.ready_in(clock["t"]) <= 0.0
                              and e.queue_depth == 0 for e in orch.engines):
            cands.append(clock["t"] + hold_tick)
        if not cands:
            break
        clock["t"] = max(clock["t"], min(cands))
        while i < n and trace[i] <= clock["t"]:
            orch.submit(pkg.api.SimRequest(rid=i), now=trace[i])
            i += 1
    return orch


@pytest.mark.parametrize("trace", ["poisson", "bursty"])
def test_trace_replay_routes_and_hit_rates_equal(sched_for, trace):
    arrivals = (_poisson(1500, 180.0, seed=1) if trace == "poisson"
                else _bursty(1500, 120.0, seed=2))
    rates = {}
    for router in ("latency", "round-robin"):
        orch, s = _both(lambda pkg, sf: _replay(pkg, sf, arrivals, router),
                        sched_for)
        st = s["stats"]
        assert st["completed"] == len(arrivals) and orch.pending == 0
        assert st["slo_hits"] + st["slo_misses"] == len(arrivals)
        rates[router] = st["slo_hit_rate"]
    assert rates["latency"] > rates["round-robin"], rates


# ---------------------------------------------------------------------------
# Real engines behind the router
# ---------------------------------------------------------------------------
def test_real_fleet_matches_reference_and_standalone(monkeypatch):
    """Two real sockets (different geometries) per package behind the
    latency router, each forward charged a fixed wall: equal routes and
    stats, and every routed logit row byte-identical to the reference's
    and to a standalone port ``nc_forward``."""
    kw = dict(img=47, width_div=8, classes=8, stages=())
    rc, tc = ri.reduced_config(**kw), ti.reduced_config(**kw)
    rparams = ri.init_params(jax.random.PRNGKey(0), config=rc)
    tparams = ti.params_from_jax(rparams, device="cpu")
    rng = np.random.default_rng(0)
    imgs = rng.random((5, rc.img, rc.img, 3)).astype(np.float32)
    clock = {"t": 0.0}

    def fake_time():
        calls = {"n": 0}

        def perf_counter():
            calls["n"] += 1
            return 0.05 * (calls["n"] // 2)
        return types.SimpleNamespace(perf_counter=perf_counter,
                                     monotonic=lambda: clock["t"])

    monkeypatch.setattr(rserve, "time", fake_time())
    monkeypatch.setattr(tserve, "time", fake_time())
    now = lambda: clock["t"]  # noqa: E731
    fleets = {
        "ref": [rserve.NCServingEngine(rparams, rc, max_batch=2, now_fn=now,
                                       engine="jit", name="socket-35MB"),
                rserve.NCServingEngine(rparams, rc, max_batch=2, now_fn=now,
                                       engine="jit", name="socket-10MB",
                                       geom=RGEOM.scaled(4, "xeon-10MB"))],
        "port": [tserve.NCServingEngine(tparams, tc, max_batch=2, now_fn=now,
                                        name="socket-35MB", device="cpu"),
                 tserve.NCServingEngine(tparams, tc, max_batch=2, now_fn=now,
                                        name="socket-10MB",
                                        geom=TGEOM.scaled(4, "xeon-10MB"),
                                        device="cpu")],
    }
    reqs = {"ref": rserve.NCRequest, "port": tserve.NCRequest}
    out = {}
    for name, pkg in PKGS.items():
        assert all(isinstance(e, pkg.api.Engine) for e in fleets[name])
        orch = pkg.orch.Orchestrator(fleets[name], slo_ms=1e7, now_fn=now)
        for i in range(5):
            clock["t"] = 0.01 * i
            orch.submit(reqs[name](rid=i, image=imgs[i]))
        clock["t"] = 1.0
        done = orch.run()
        summary = _summary(orch)
        for e in summary["stats"]["engines"].values():
            e.pop("errors")
        out[name] = (done, summary)
    assert out["ref"][1] == out["port"][1]
    done, s = out["port"]
    assert len(done) == 5 and s["stats"]["completed"] == 5
    assert s["stats"]["slo_hits"] + s["stats"]["slo_misses"] == 5
    assert sum(s["dispatched"].values()) == sum(
        s["stats"]["batch_histogram"].values())
    ref_logits = {r.rid: np.asarray(r.logits) for r in out["ref"][0]}
    for r in done:
        assert r.latency_s is not None and r.slo_ok is not None
        alone, _ = ti.nc_forward(tparams, imgs[r.rid], config=tc,
                                 device="cpu")
        assert torch.equal(alone.view(torch.int32), r.logits.view(torch.int32))
        assert (ref_logits[r.rid].view(np.uint32)
                == r.logits.numpy().view(np.uint32)).all()
