"""The port's NCServingEngine against the reference engine under a binding
SLO: a fake clock that advances per request, and a fake ``perf_counter``
that charges every forward a fixed wall, so that the measured walls reach
the latency model and the deadline binds.

Both serving modules read ``time.perf_counter`` around each forward; the
fake is patched in as each module's ``time`` name, so that no file of the
reference is edited.  The admission path (holds, ``ragged-early``, the p99
calibration, SLO hits and misses) must give equal decisions, histograms,
SLO stats and calibrated p99 curves after every step; served logits stay
byte-identical.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as rserve
from repro.models import inception as ri
from repro_torch.launch import serve as tserve
from repro_torch.models import inception as ti

torch.set_num_threads(1)

KW = dict(img=31, width_div=8, classes=8, stages=())  # stem only
WALL_S = 0.1  # charged to every forward

# (arrival time, step on arrival): two close arrivals fill a batch of 2,
# sparse arrivals flush ragged batches early, and a request left queued
# past its deadline is served late (a miss)
EVENTS = [(0.0, True), (0.05, True), (2.0, True), (3.0, True),
          (3.02, True), (5.0, False), (5.5, True), (7.0, True),
          (7.01, True), (7.02, False)]


@pytest.fixture(scope="module")
def tiny():
    rc, tc = ri.reduced_config(**KW), ti.reduced_config(**KW)
    params = ri.init_params(jax.random.key(1), config=rc)
    rng = np.random.default_rng(4)
    images = [rng.random((rc.img, rc.img, 3), dtype=np.float32)
              for _ in EVENTS]
    return rc, tc, params, ti.params_from_jax(params, device="cpu"), images


def _fake_time(clock):
    """``perf_counter`` returning 0, W, W, 2W, 2W, ...: the two reads
    around each forward are W apart."""
    calls = {"n": 0}

    def perf_counter():
        n = calls["n"]
        calls["n"] += 1
        return WALL_S * ((n + 1) // 2)

    return types.SimpleNamespace(perf_counter=perf_counter,
                                 monotonic=lambda: clock["t"])


def _snapshot(engine):
    lm = engine.latency_model
    return dict(
        decisions=[(d.admit, d.target, d.reason) for d in engine.decisions],
        budgets=[d.budget_s for d in engine.decisions],
        histogram=dict(engine.batch_histogram),
        hits=engine.slo_hits, misses=engine.slo_misses,
        p99=[lm.predict_p99_s(n) for n in range(1, engine.batch_cap + 1)],
        scale=lm.scale, samples=lm.samples)


@pytest.mark.parametrize("slo_ms,hold_slack_ms", [(200.0, 30.0),
                                                  (200.0, 60.0),
                                                  (150.0, None)])
def test_admission_matches_reference_under_binding_slo(tiny, monkeypatch,
                                                       slo_ms, hold_slack_ms):
    rc, tc, rparams, tparams, images = tiny
    clock = {"t": 0.0}
    monkeypatch.setattr(rserve, "time", _fake_time(clock))
    monkeypatch.setattr(tserve, "time", _fake_time(clock))
    kw = dict(max_batch=2, slo_ms=slo_ms, hold_slack_ms=hold_slack_ms,
              now_fn=lambda: clock["t"])
    ref = rserve.NCServingEngine(rparams, rc, engine="jit", **kw)
    port = tserve.NCServingEngine(tparams, tc, device="cpu", **kw)
    for i, (t, step) in enumerate(EVENTS):
        clock["t"] = t
        ref.submit(rserve.NCRequest(rid=i, image=images[i]))
        port.submit(tserve.NCRequest(rid=i, image=images[i]))
        if step:
            assert ref.step() == port.step()
        assert _snapshot(ref) == _snapshot(port), f"after arrival {i}"
    clock["t"] = 8.0
    ref.run()
    port.run()
    r, p = _snapshot(ref), _snapshot(port)
    assert r == p
    reasons = [d[2] for d in p["decisions"]]
    assert "hold" in reasons and "ragged-early" in reasons
    assert p["misses"] >= 1 and p["hits"] >= 1
    assert p["hits"] + p["misses"] == len(EVENTS)
    r_stats, t_stats = ref.stats(), port.stats()
    for key in ("steps", "completed", "batch_histogram", "slo_hits",
                "slo_misses", "slo_hit_rate", "calibration_scale",
                "calibration_samples", "calibration_excluded"):
        assert r_stats[key] == t_stats[key], key
    r_done = sorted(ref.completed, key=lambda q: q.rid)
    t_done = sorted(port.completed, key=lambda q: q.rid)
    assert [(q.rid, q.latency_s, q.slo_ok) for q in r_done] == [
        (q.rid, q.latency_s, q.slo_ok) for q in t_done]
    for a, b in zip(r_done, t_done):
        assert (np.asarray(a.logits).view(np.uint32)
                == b.logits.numpy().view(np.uint32)).all()


def test_fake_wall_reaches_the_latency_model(tiny, monkeypatch):
    """The charged wall, not the host's, calibrates the port's model: after
    one batch of n the mean ratio is exactly WALL_S / modeled(n)."""
    _, tc, _, tparams, images = tiny
    clock = {"t": 0.0}
    monkeypatch.setattr(tserve, "time", _fake_time(clock))
    port = tserve.NCServingEngine(tparams, tc, max_batch=2, slo_ms=500.0,
                                  now_fn=lambda: clock["t"], device="cpu")
    port.submit(tserve.NCRequest(rid=0, image=images[0]))
    port.submit(tserve.NCRequest(rid=1, image=images[1]))
    assert port.step()
    lm = port.latency_model
    assert lm.samples == 1
    assert lm.scale == WALL_S / lm.modeled_batch_s(2)
    assert [r.latency_s for r in port.completed] == [WALL_S, WALL_S]
