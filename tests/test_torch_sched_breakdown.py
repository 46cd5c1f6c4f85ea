"""The port's ``sched_breakdown`` against the reference's, on the CPU.

The reference reads its two measured inputs from ``BENCH_kernels.json``;
here its ``load_bench_baseline`` is patched to hand it the same inputs the
port's ``run`` is given (a calibration wall and a serial/overlapped pair,
one wall a side), and every row must be equal as text, through ``run`` and
through each row function.  Every gate of the reference raises in the port
with the same message on the same planted inputs (the planted function
patched into both modules); on the committed pair (2.96 s serial, 3.04 s
overlapped) both raise the measured-overlap gate on a host with more
than one core.  The port's own rule for a measured pair (medians in
turns, plus the larger spread) is held on planted walls, and its
measuring functions' correctness gates on a planted forward.
"""
import os
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.sched_breakdown as R  # noqa: E402
import repro.core.simulator as rsim  # noqa: E402
from repro_torch.benchmarks import sched_breakdown as T  # noqa: E402
from repro_torch.benchmarks.common import same_bits  # noqa: E402

torch.set_num_threads(1)

# BENCH_kernels.json's records (us) of the two measured inputs
COMMITTED_CAL_US = 1314534.66
COMMITTED_PAIR_US = (2964775.62, 3037628.3)


def _inject(monkeypatch, cal_us, serial_us, overlap_us):
    """Hand the reference these walls (us) as its baseline; returns the
    port's arguments (seconds)."""
    base = {R.CALIBRATION_OP: cal_us, R.OVERLAP_OPS[0]: serial_us,
            R.OVERLAP_OPS[1]: overlap_us}
    monkeypatch.setattr(R, "load_bench_baseline", lambda *a, **k: base)
    return dict(calibration_wall_s=cal_us / 1e6,
                overlap_walls=([serial_us / 1e6], [overlap_us / 1e6]))


@pytest.mark.parametrize("cal_us,serial_us,overlap_us,cores", [
    (COMMITTED_CAL_US, COMMITTED_PAIR_US[0], 2.9e6, 8),
    (COMMITTED_CAL_US, *COMMITTED_PAIR_US, 1),  # 1.25x slack passes it
    (5e4, 1.0e6, 0.5e6, 8),
    (2.0e7, 3.0e6, 3.0e6, 8),
])
def test_rows_equal_reference(monkeypatch, cal_us, serial_us, overlap_us,
                              cores):
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    kw = _inject(monkeypatch, cal_us, serial_us, overlap_us)
    rows = T.run(**kw)
    assert rows == R.run()
    assert len(rows) == 96
    assert sum(r.split(",", 1)[0].endswith("_emulated") for r in rows) == 4


def test_row_functions_equal_reference(monkeypatch):
    kw = _inject(monkeypatch, COMMITTED_CAL_US, COMMITTED_PAIR_US[0], 2.5e6)
    rspecs, tspecs = R.inception_v3_specs(), T.inception_v3_specs()
    assert T._compression_rows(tspecs) == R._compression_rows(rspecs)
    rr = R.simulate_network(R.plan_network(rspecs, R.XEON_E5_35MB, batch=64))
    tr = T.simulate_network(T.plan_network(tspecs, T.XEON_E5_35MB, batch=64))
    assert (T._overlap_rows(tspecs, tr, kw["overlap_walls"])
            == R._overlap_rows(rspecs, rr))
    assert (T._slo_rows(tspecs, kw["calibration_wall_s"])
            == R._slo_rows(rspecs))


def _wrap(name, change):
    """A factory patching ``name`` in a module with ``change(original)``."""
    return lambda mod: (mod, name, change(getattr(mod, name)))


def _more_credit(f):
    def g(*a, **k):
        d = dict(f(*a, **k))
        d["skip_credit_cycles"] += 1
        return d
    return g


def _uncompressed(f):
    return lambda specs, geom, **kw: f(
        specs, geom, **{k: v for k, v in kw.items() if k != "compressed"})


def _flat_curve(cls):
    class Flat(cls):
        def predict_p99_s(self, batch):
            return 1e-3
    return Flat


GATES = {
    "throughput-monotone": (_wrap("throughput", lambda f: (
        lambda r, b: 1000.0 / b)), "throughput-vs-batch not monotone"),
    "throughput-plateau": (_wrap("throughput", lambda f: (
        lambda r, b: float(min(b, 64)))), "batch-64 plateau 64.0 inf/s"),
    "throughput-no-plateau": (_wrap("throughput", lambda f: (
        lambda r, b: 604.0 * b / 64)), "no plateau"),
    "sparse-credit": (_wrap("modeled_layer_cycles", _more_credit),
                      "sparse modeled cycles off the skipped-pass credit"),
    "overlap-identity": (None, "batch-64 overlap identity broken"),
    "compression-limit": (_wrap("plan_network", _uncompressed),
                          "compression gate: stream_batch_limit"),
    "slo-curve": (_wrap("LatencyModel", _flat_curve),
                  "predicted latency not strictly increasing in batch"),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_every_gate_raises_as_reference(monkeypatch, gate):
    planting, pattern = GATES[gate]
    kw = _inject(monkeypatch, COMMITTED_CAL_US, COMMITTED_PAIR_US[0], 2.5e6)
    if planting is None:
        # the overlapped batch time off by 1%; the reference imports
        # batch_time_s inside its row function
        for mod in (rsim, T):
            monkeypatch.setattr(mod, "batch_time_s", (
                lambda f: lambda r, b: f(r, b) * (1.01 if r.hidden_s else 1)
            )(mod.batch_time_s))
    else:
        for mod in (R, T):
            monkeypatch.setattr(*planting(mod))
    with pytest.raises(RuntimeError, match=pattern) as ref:
        R.run()
    with pytest.raises(RuntimeError, match=pattern) as port:
        T.run(**kw)
    assert str(port.value) == str(ref.value)


def test_committed_pair_raises_in_both_on_many_cores(monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    kw = _inject(monkeypatch, COMMITTED_CAL_US, *COMMITTED_PAIR_US)
    msg = ("measured overlapped wall 3.04 s exceeds 1.00x serial 2.96 s")
    with pytest.raises(RuntimeError, match=msg):
        R.run()
    with pytest.raises(RuntimeError, match=msg):
        T.run(**kw)


def test_overlap_gate_in_turns_on_planted_walls(monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    serial = [1.0, 1.1, 1.2, 1.05, 1.0]
    # a median above serial's but inside the spread passes
    ws, wo, spread = T.overlap_gate(serial, [1.15, 1.2, 1.1, 1.25, 1.12])
    assert (ws, wo) == (1.05, 1.15) and spread == pytest.approx(0.2)
    with pytest.raises(RuntimeError, match=(
            r"measured overlapped wall 1\.50 s exceeds 1\.00x serial "
            r"1\.05 s plus the spread 0\.20 s")):
        T.overlap_gate(serial, [1.5, 1.5, 1.5, 1.5, 1.5])
    # the overlapped side's own spread counts too
    T.overlap_gate(serial, [1.0, 1.6, 1.3, 1.2, 1.2])


@pytest.mark.parametrize("cores", [1, 8])
@pytest.mark.parametrize("ws,wo", [(2.96, 3.04), (2.0, 2.0), (2.0, 2.4),
                                   (2.0, 2.6), (3.0, 1.0)])
def test_overlap_gate_on_one_wall_a_side_is_the_reference_rule(
        monkeypatch, cores, ws, wo):
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    slack = 1.0 if cores > 1 else 1.25
    if wo > slack * ws:
        with pytest.raises(RuntimeError, match="became a cost"):
            T.overlap_gate([ws], [wo])
    else:
        assert T.overlap_gate([ws], [wo]) == (ws, wo, 0.0)


def test_run_measures_what_it_is_not_given(monkeypatch):
    asked = []
    monkeypatch.setattr(T, "measure_calibration",
                        lambda device: asked.append(("cal", device)) or 2.5)
    monkeypatch.setattr(T, "measure_overlap", lambda device: asked.append(
        ("pair", device)) or ([1.0] * 5, [1.0] * 5))
    rows = T.run(device="cpu")
    assert asked == [("cal", "cpu"), ("pair", "cpu")]
    assert any(r.startswith("slo/calibration,") for r in rows)
    asked.clear()
    T.run(device="cpu", calibration_wall_s=1.0, overlap_walls=([1.0], [1.0]))
    assert asked == []


def test_measuring_on_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for fn in (T.measure_calibration, T.measure_overlap,
               T.calibration_walls, T.calibration_case, T.overlap_case):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            fn(None)


def _diverging(monkeypatch, when):
    real = T.inception.nc_forward

    def forward(*a, **k):
        logits, report = real(*a, **k)
        if k.get(when):
            logits = logits.clone()
            logits[0, 0] += 1.0
        return logits, report

    monkeypatch.setattr(T.inception, "nc_forward", forward)


def test_measure_overlap_fails_on_diverging_logits(monkeypatch):
    _diverging(monkeypatch, "overlap")
    with pytest.raises(RuntimeError, match="overlapped nc_forward logits "
                                           "diverge"):
        T.measure_overlap("cpu")


def test_measure_calibration_fails_on_diverging_logits(monkeypatch):
    monkeypatch.setattr(T, "CALIBRATION_RUNS", 1)
    _diverging(monkeypatch, "sparse")
    with pytest.raises(RuntimeError, match="sparse nc_forward logits "
                                           "diverge"):
        T.measure_calibration("cpu")


def test_measuring_forwards_hand_back_their_logits(monkeypatch):
    """Every wall a side, and each side's logits equal to its case's
    forward, so that a caller can hold them against another forward."""
    monkeypatch.setattr(T, "CALIBRATION_RUNS", 2)
    monkeypatch.setattr(T, "OVERLAP_RUNS", 1)
    logits = {}
    walls = T.calibration_walls("cpu", logits=logits)
    assert sorted(walls) == ["dense", "sparse"]
    assert all(len(w) == 2 and min(w) > 0 for w in walls.values())
    serial, overlapped = T.measure_overlap("cpu", logits=logits)
    assert len(serial) == len(overlapped) == 1
    forwards = {**T.calibration_case("cpu"), **T.overlap_case("cpu")}
    assert sorted(logits) == sorted(forwards)
    for name, forward in forwards.items():
        assert same_bits(forward()[0], logits[name]), name


def test_command_line(monkeypatch, capsys):
    monkeypatch.setattr(T, "measure_calibration", lambda device: 2.5)
    monkeypatch.setattr(T, "measure_overlap",
                        lambda device: ([1.0] * 5, [1.0] * 5))
    assert T.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == T.run(
        calibration_wall_s=2.5, overlap_walls=([1.0] * 5, [1.0] * 5))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            T.main([])
