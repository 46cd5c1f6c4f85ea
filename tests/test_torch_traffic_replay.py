"""The port's ``traffic_replay`` against the reference's, on the CPU.

The simulated fleet runs on a fake clock with seeded jitter, so every
replay row is deterministic and must be equal as text: both routers on a
Poisson and a bursty trace cut to 2,000 requests each, and
``run_quick``.  The accounting identities and the router gate raise the
same messages on planted fleets.  The real fleet (three
``NCServingEngine`` sockets, the reduced stem config) serves the
reference's 6 images with the reference's weights (``params_from_jax``),
every routed logit row byte-identical to the reference's standalone
``nc_forward``; a row shift planted in one served logit row must fail.
The full replay (10^5 requests a router, about 2 minutes of host Python
per package) is marked ``slow``.
"""
import pathlib
import sys
import types

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.traffic_replay as R  # noqa: E402
from repro.models import inception as ri  # noqa: E402
from repro_torch.benchmarks import traffic_replay as T  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import inception as ti  # noqa: E402

torch.set_num_threads(1)

CUT = 2000  # requests a trace in tier-1
STEM = dict(img=47, width_div=8, classes=8, stages=())


def test_traces_equal_reference():
    for args in ((CUT, R.POISSON_RATE_HZ, 1), (7, 3.0, 5)):
        assert T.make_poisson_trace(*args) == R.make_poisson_trace(*args)
        assert T.make_bursty_trace(*args) == R.make_bursty_trace(*args)
    kw = dict(burst=4.0, lull=0.1, period_s=0.5)
    assert (T.make_bursty_trace(300, 50.0, 3, **kw)
            == R.make_bursty_trace(300, 50.0, 3, **kw))


def test_fleet_equals_reference():
    assert T.FLEET_SPEC == R.FLEET_SPEC
    assert (T.SLO_MS, T.POISSON_RATE_HZ, T.BURSTY_RATE_HZ, T.JITTER) == (
        R.SLO_MS, R.POISSON_RATE_HZ, R.BURSTY_RATE_HZ, R.JITTER)
    for te, re_ in zip(T.make_fleet(), R.make_fleet()):
        assert (te.name, te.max_batch, te.batch_cap) == (
            re_.name, re_.max_batch, re_.batch_cap)
        for n in (1, 2, 4):
            assert (te.latency_model.predict_p99_s(n)
                    == re_.latency_model.predict_p99_s(n))


@pytest.mark.parametrize("trace", ["poisson", "bursty"])
def test_cut_trace_rows_equal_reference(trace):
    if trace == "poisson":
        arrivals = R.make_poisson_trace(CUT, R.POISSON_RATE_HZ, seed=1)
    else:
        arrivals = R.make_bursty_trace(CUT, R.BURSTY_RATE_HZ, seed=2)
    rows, rates = T._replay_pair(trace, arrivals)
    assert (rows, rates) == R._replay_pair(trace, arrivals)
    assert rates["latency"] > rates["round-robin"]


def test_run_quick_equals_reference():
    rows = T.run_quick()
    assert rows == R.run_quick() and len(rows) == 1


def _orch(completed=10, failed=0, hits=10, misses=0, pending=0, hist=None):
    stats = dict(completed=completed, failed=failed, slo_hits=hits,
                 slo_misses=misses,
                 batch_histogram=hist if hist is not None else {2: 5})
    return types.SimpleNamespace(stats=lambda: stats, pending=pending)


@pytest.mark.parametrize("orch,msg", [
    (_orch(completed=9), r"9 completed \+ 0 failed != 10 submitted"),
    (_orch(hits=8, misses=1), r"slo_hits 8 \+ slo_misses 1"),
    (_orch(pending=2), "2 requests stranded"),
    (_orch(hist={2: 4, 1: 1}), "histogram admits 9 != 10 finished"),
], ids=["submitted", "slo", "stranded", "histogram"])
def test_accounting_gates_raise_as_reference(orch, msg):
    with pytest.raises(RuntimeError, match=msg) as ref:
        R._check_accounting(orch, 10, "x/latency")
    with pytest.raises(RuntimeError, match=msg) as port:
        T._check_accounting(orch, 10, "x/latency")
    assert str(port.value) == str(ref.value)
    T._check_accounting(_orch(), 10, "x/latency")


def test_router_gate_raises_as_reference(monkeypatch):
    """Both routers swapped: round-robin's rate under the latency label."""
    for mod in (R, T):
        real = mod.replay
        monkeypatch.setattr(mod, "replay", (lambda real: lambda trace, router,
                                            **k: real(trace, {
                                                "latency": "round-robin",
                                                "round-robin": "latency"
                                            }[router], **k))(real))
    arrivals = R.make_poisson_trace(500, R.POISSON_RATE_HZ, seed=1)
    msg = "poisson: latency router hit rate .* does not beat round-robin"
    with pytest.raises(RuntimeError, match=msg) as ref:
        R._replay_pair("poisson", arrivals)
    with pytest.raises(RuntimeError, match=msg) as port:
        T._replay_pair("poisson", arrivals)
    assert str(port.value) == str(ref.value)
    with pytest.raises(RuntimeError, match="quick: latency router") as ref:
        R.run_quick()
    with pytest.raises(RuntimeError, match="quick: latency router") as port:
        T.run_quick()
    assert str(port.value) == str(ref.value)


@pytest.fixture(scope="module")
def stem():
    """The reference real fleet's config, weights, 6 images and the
    reference's standalone logits of each."""
    cfg = ri.reduced_config(**STEM)
    params = ri.init_params(jax.random.PRNGKey(0), config=cfg)
    images = np.random.default_rng(0).uniform(
        size=(6, cfg.img, cfg.img, 3)).astype(np.float32)
    logits = [torch.from_numpy(np.array(ri.nc_forward(params, im,
                                                      config=cfg)[0]))
              for im in images]
    return types.SimpleNamespace(
        cfg=ti.reduced_config(**STEM), images=images, logits=logits,
        params=ti.params_from_jax(params, device="cpu"))


def test_real_fleet_serves_reference_logits(stem):
    line = T._real_fleet_bitidentity(stem.params, stem.cfg, stem.images,
                                     stem.logits, device="cpu")
    name, us, text = line.split(",", 2)
    assert name == "replay/real_fleet_bitident" and float(us) > 0
    assert text.startswith("6 imgs byte-identical across ")
    assert text.endswith(" real sockets")


def test_real_fleet_hands_back_its_batches(stem):
    stats = {}
    T._real_fleet_bitidentity(stem.params, stem.cfg, stem.images,
                              stem.logits, device="cpu", stats=stats)
    assert list(stats["forwards"]) == ["socket-35MB", "socket-17MB",
                                       "socket-10MB"]
    assert (sum(stats["forwards"].values())
            == sum(stats["batch_histogram"].values())
            == sum(stats["dispatched"].values()))
    assert stats["completed"] == 6 and stats["failed"] == 0


def test_real_fleet_defaults_are_the_reference_s(stem):
    """No arguments: the reference's stem config, seeded weights of the
    port's own and the reference's 6 images, held to standalone forwards."""
    line = T._real_fleet_bitidentity(device="cpu")
    assert line.split(",", 2)[2].startswith("6 imgs byte-identical")


def test_real_fleet_fails_on_a_shifted_logit_row(stem, monkeypatch):
    real = tserve.NCServingEngine._forward
    calls = []

    def forward(engine, *a, **k):
        logits, report = real(engine, *a, **k)
        calls.append(None)
        if len(calls) == 2:
            logits = logits.clone()
            logits[0] = torch.roll(logits[0], 1)
        return logits, report

    monkeypatch.setattr(tserve.NCServingEngine, "_forward", forward)
    with pytest.raises(RuntimeError, match=r"real-fleet: request \d logits "
                                           r"differ from the reference"):
        T._real_fleet_bitidentity(stem.params, stem.cfg, stem.images,
                                  stem.logits, device="cpu")
    calls.clear()
    with pytest.raises(RuntimeError, match=r"real-fleet: request \d logits "
                                           r"differ from standalone"):
        T._real_fleet_bitidentity(stem.params, stem.cfg, stem.images,
                                  device="cpu")


def test_real_fleet_on_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        T._real_fleet_bitidentity()


@pytest.mark.slow
def test_full_replay_rows_equal_reference(monkeypatch):
    """``run()``'s 10^5-request replays (both traces, both routers, the
    gate row); the real-fleet row, whose wall moves, is held apart."""
    rows = T.run(device="cpu")
    ref = R.run()
    assert rows[:-1] == ref[:-1] and len(rows) == 6
    assert rows[-1].split(",", 2)[2] == ref[-1].split(",", 2)[2]


def test_command_line(capsys):
    assert T.main(["--quick", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == R.run_quick()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            T.main(["--quick"])
