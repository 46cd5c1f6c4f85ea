"""``repro_torch.tracing``: spans and counters inside the served forward.

Off, a span and a counted read cost no clock read and record nothing.  On
(inside ``tracing.session()`` or a ``torch.profiler`` session), the spans
nest and cut the time exactly as the benchmark's ``SpanRecorder`` does, a
served tiny Inception batch records every span of the forward, and the
``host_syncs`` counter equals the count stated in ``PERF.md``: per
convolution 2 reads in the requantization (the min/max tree's results in
one read and the largest live-output count), one copy in the bias add, one
in the operands' packing, one zero-operand read, plus the pruned and
compressed layers' terms.  The requantization counts one launch for the
whole batch (``requant.rows`` over ``requant.launches`` is the batch), one
a convolution and one a concatenated branch.  Logits and reports are the
same with tracing on and off.
"""
import copy
import json
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import backends
from repro_torch.core import bitserial as bs
from repro_torch.core import nc_layers as nc

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ncbench import harness, spans, trace  # noqa: E402
from ncbench.builders import inception as builder  # noqa: E402
from ncbench.conftest import TINY  # noqa: E402

CPU = torch.device("cpu")
CELLS = ["inception_v3-hostq.throughput",
         "inception_v3-pruned50-hostq.throughput"]
SPAN_NAMES = {"serve.step", "forward", "conv", "layer", "layer.pack", "dot",
              "layer.correct", "epilogue.bias_relu", "minmax", "minmax.tree",
              "epilogue.requant", "pool", "concat", "fc"}


def _raise(*args, **kwargs):
    raise AssertionError("called while tracing is off")


class FakeClock:
    """``perf_counter_ns`` advancing by a fixed step on every read."""

    def __init__(self, step=1000):
        self.ns, self.step = 10 ** 9, step

    def __call__(self):
        self.ns += self.step
        return self.ns


def _engine(name, seed=5):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell.find(copy.deepcopy(manifest), name, ROOT)
    cell.config.update(TINY)
    traffic = dict(cell.traffic, batch=2)
    params = builder.make_params(cell.config,
                                 torch.Generator().manual_seed(seed), CPU)
    return builder.build_engine(params, cell.config, traffic, CPU), cell


def _serve(engine, cell, seed=11, first_rid=0):
    images = builder.make_images(cell.config, 2,
                                 torch.Generator().manual_seed(seed), CPU)
    batch = [builder.request(first_rid + i, img)
             for i, img in enumerate(images)]
    for r in batch:
        engine.submit(r)
    assert engine.step()
    engine.completed.clear()
    return batch


@pytest.fixture(autouse=True)
def _no_session_left_open():
    yield
    assert not tracing._forced


def test_off_reads_no_clock_and_records_nothing(monkeypatch):
    before = tracing.last_session()
    monkeypatch.setattr(time, "perf_counter_ns", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert not tracing.enabled()
    with tracing.span("outer", 3):
        with tracing.span("inner"):
            tracing.annotate("key", [1, 2])
            assert tracing.fetch(int, torch.tensor(7)) == 7
            assert tracing.fetch(torch.nonzero, torch.tensor(
                [0, 1, 1])).flatten().tolist() == [1, 2]
    assert tracing._current is None
    assert tracing.last_session() is before


def test_off_served_batch_reads_no_clock_and_creates_no_session(
        monkeypatch):
    engine, cell = _engine(CELLS[1])
    before = tracing.last_session()
    monkeypatch.setattr(time, "perf_counter_ns", _raise)
    batch = _serve(engine, cell)
    assert all(r.logits is not None and not r.failed for r in batch)
    assert tracing._current is None
    assert tracing.last_session() is before


def _calls(span, fetch):
    """One fixed sequence of nested spans (and counted reads)."""
    with span("serve"):
        with span("forward"):
            with span("layer"):
                with span("dot"):
                    fetch(int, torch.tensor(1))
            fetch(int, torch.tensor(2))
            with span("minmax"):
                pass
        with span("forward"):
            pass


def test_spans_match_span_recorder(monkeypatch):
    monkeypatch.setattr(time, "perf_counter_ns", FakeClock())
    rec = spans.SpanRecorder(CPU)

    def timed(f, *args):  # reads the clock as a counted read does
        time.perf_counter_ns()
        f(*args)
        time.perf_counter_ns()
    _calls(rec.span, timed)
    monkeypatch.setattr(time, "perf_counter_ns", FakeClock())
    with tracing.session() as s:
        _calls(tracing.span, tracing.fetch)
    assert tracing.last_session() is s
    # the same clock reads in the same order: the same records
    assert s.records == rec.records
    assert s.totals() == rec.totals()
    assert s.segments() == rec.segments()
    assert s.counters() == {
        "dot": {"host_syncs": 1, "host_wait_ns": 1000},
        "forward": {"host_syncs": 1, "host_wait_ns": 1000}}
    # a device trace of two kernels over the spans' window
    segs = s.segments()
    t0, t1 = segs[0][0], segs[-1][1]
    tr = dict(starts=np.array([t0 + 500, t0 + 4500], np.int64),
              ends=np.array([t0 + 1500, t0 + 5000], np.int64),
              names=["k1", "k2"], offset_ns=0)
    got = trace.summarize(tr, t0, t1, segs)
    assert got == trace.summarize(tr, t0, t1, rec.segments())
    assert got["busy_s"] == pytest.approx(1500 / 1e9)
    idle = dict(got["idle_gaps"])
    assert sum(idle.values()) == pytest.approx((t1 - t0 - 1500) / 1e9)
    assert set(idle) <= {name for _, _, name in segs}


def test_span_closes_on_error_and_carries_its_ident():
    with tracing.session() as s:
        with pytest.raises(ValueError):
            with tracing.span("serve.step", 4):
                tracing.annotate("requests", [8, 9])
                with tracing.span("conv", "Conv2d_1a_3x3"):
                    raise ValueError("inside")
        with tracing.span("after"):
            pass
    assert [r[0] for r in s.records] == ["conv", "serve.step", "after"]
    assert [r[3] for r in s.records] == [1, 0, 0]
    assert s.idents == [("Conv2d_1a_3x3", 4), (4, 4), (None, None)]
    assert s.attrs == {1: {"requests": [8, 9]}}
    assert not s._stack


def test_profiler_switches_tracing_on_and_off():
    from torch.profiler import ProfilerActivity, profile

    assert not tracing.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        with tracing.span("a", 1):
            tracing.fetch(int, torch.tensor(5))
    assert not tracing.enabled()
    s = tracing.last_session()
    assert s.totals()["a"]["count"] == 1
    assert s.counters()["a"]["host_syncs"] == 1
    # the spans are ranges of the profiler's trace, by name
    assert "a" in {e.name for e in prof.events()}
    with tracing.span("b"):
        pass
    assert tracing.last_session() is s
    assert "b" not in s.totals()
    # a new profiler session is a new session
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("c"):
            pass
    s2 = tracing.last_session()
    assert s2 is not s and set(s2.totals()) == {"c"}


def expected_host_syncs(engine, B: int) -> int:
    """``PERF.md``'s count of one served batch of ``B`` images."""
    n = 0
    for plan in engine._schedule_for(B).layers:
        spec = plan.spec
        if spec.kind not in ("conv", "fc"):
            continue
        wq = engine.wpack[spec.name][0]
        n += 2  # the operands: zero points copied, zero-operand count read
        if wq.device != engine.device:
            n += 1  # the filters' copy to the device
        n += 3 if spec.kind == "conv" else 1  # epilogue / logits scale
        K = spec.R * spec.S * spec.C
        if bs._row_layout(K)[2] > 1:
            n += 1  # the filter grid's row test in the gemm's decode
        zero = plan.occupancy.zero_filters if plan.occupancy else ()
        if zero:
            n += 5  # indices copied, checked, marked, gathered, filled
        if plan.compressed:
            n += 4  # the CSR store's bytes counted from the filter words
    return n


@pytest.mark.parametrize("name", CELLS)
def test_served_batch_records_every_span_and_counts_its_syncs(name):
    engine, cell = _engine(name)
    _serve(engine, cell)  # the warm-up batch, off
    with tracing.session():
        batch = _serve(engine, cell, first_rid=2)
    s = tracing.last_session()
    totals = s.totals()
    assert set(totals) == SPAN_NAMES
    assert totals["serve.step"]["count"] == 1
    convs = sum(1 for p in engine.schedule.layers if p.spec.kind == "conv")
    assert totals["conv"]["count"] == convs
    assert totals["layer"]["count"] == convs + 1
    assert totals["minmax"]["count"] == totals["minmax.tree"]["count"] == convs
    # every span of the batch shares its number; the step carries its
    # requests
    assert {root for _, root in s.idents} == {1}
    step = [i for i, r in enumerate(s.records) if r[0] == "serve.step"]
    assert s.attrs == {step[0]: {"requests": [r.rid for r in batch]}}
    counters = s.counters()
    assert counters["epilogue.requant"]["host_syncs"] == convs * 2
    total = sum(c["host_syncs"] for c in counters.values())
    assert total == expected_host_syncs(engine, 2)
    # the concatenations count their launches and make no sync
    assert counters["concat"]["host_syncs"] == 0
    assert all(c["host_wait_ns"] > 0 for c in counters.values()
               if c["host_syncs"])


def _branches(config) -> int:
    """Branch outputs the forward concatenates: each mixed block's, and
    those of the splits inside its branches."""
    def splits(ops):
        return sum(len(op[1:]) + sum(splits(sub) for sub in op[1:])
                   for op in ops if op[0] == "split")
    return sum(len(br) + sum(splits(b) for b in br)
               for _, br in config.mixed)


@pytest.mark.parametrize("name", CELLS)
def test_served_batch_requantizes_each_layer_in_one_launch(name):
    engine, cell = _engine(name)
    _serve(engine, cell)
    with tracing.session():
        _serve(engine, cell, first_rid=2)
    c = tracing.last_session().counters()
    convs = sum(1 for p in engine.schedule.layers if p.spec.kind == "conv")
    branches = _branches(engine.config)
    assert c["epilogue.requant"]["requant.launches"] == convs
    assert c["concat"]["requant.launches"] == branches
    for span in ("epilogue.requant", "concat"):
        assert c[span]["requant.rows"] == 2 * c[span]["requant.launches"]
    launches = sum(v.get("requant.launches", 0) for v in c.values())
    assert launches == convs + branches


@pytest.mark.parametrize("config,convs,branches", [
    ("FULL", 94, 50), ("reduced", 41, 22)])
def test_forward_requant_launches_one_a_conv_and_branch(config, convs,
                                                        branches):
    from repro_torch.models import inception

    cfg = (inception.FULL if config == "FULL"
           else inception.reduced_config())
    specs = inception.inception_v3_specs(cfg)
    assert sum(1 for s in specs if s.kind == "conv") == convs
    assert _branches(cfg) == branches
    if config == "reduced":  # a traced forward at the reduced 79 px config
        params = inception.init_params(torch.Generator().manual_seed(0),
                                       config=cfg, device="cpu")
        x = torch.rand((3, cfg.img, cfg.img, 3),
                       generator=torch.Generator().manual_seed(1))
        with tracing.session():
            inception.nc_forward(params, x, config=cfg, device="cpu")
        c = tracing.last_session().counters()
        launches = sum(v.get("requant.launches", 0) for v in c.values())
        rows = sum(v.get("requant.rows", 0) for v in c.values())
        assert launches == convs + branches and rows == 3 * launches


@pytest.mark.parametrize("name", CELLS)
def test_logits_and_reports_identical_on_and_off(name):
    engine, cell = _engine(name)
    _serve(engine, cell)
    runs = []
    for on in (False, True, False):
        bs.SKIP_STATS.reset()
        backends.dispatch_stats_clear()
        reports = len(engine.reports)
        if on:
            with tracing.session():
                batch = _serve(engine, cell)
        else:
            batch = _serve(engine, cell)
        runs.append(([r.logits for r in batch], engine.reports[reports:],
                     bs.SKIP_STATS.snapshot(), backends.dispatch_stats()))
    for other in runs[1:]:
        for a, b in zip(runs[0][0], other[0]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert other[1:] == runs[0][1:]


def test_conv_stats_identical_on_and_off():
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (2, 9, 9, 6), generator=g).to(torch.uint8)
    w = torch.randint(0, 256, (3, 3, 6, 8), generator=g)
    from repro_torch.core import quantize as q
    xq = [q.QuantParams(scale=0.02, zero_point=3),
          q.QuantParams(scale=0.03, zero_point=7)]
    wq = q.QuantParams(scale=0.01, zero_point=128)
    off = nc.nc_conv2d(x, w, xq, wq, 1, padding="SAME", engine="gemm",
                       return_stats=True)
    with tracing.session():
        on = nc.nc_conv2d(x, w, xq, wq, 1, padding="SAME", engine="gemm",
                          return_stats=True)
    assert torch.equal(off[0], on[0]) and off[1:] == on[1:]
    got = tracing.last_session().counters()
    assert got["layer.pack"]["host_syncs"] == 1
    assert got["layer.correct"]["host_syncs"] == 1


def test_chip_smoke_split_reads_the_program_spans(monkeypatch):
    """``chip_smoke.phase_split`` on the CPU at the reduced config, CUDA's
    synchronize stubbed: five stages from the spans, nothing patched."""
    import chip_smoke as cs
    from repro_torch.models import inception

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = inception.reduced_config(img=47, width_div=4, classes=10,
                                   stages=("a",))
    params = inception.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    wpack = inception.prepare_conv_weights(params, cfg)
    x = torch.rand((2, 47, 47, 3), generator=torch.Generator().manual_seed(1))
    attrs = (inception.nc_forward, nc.nc_conv2d, bs.packed_dot_words,
             nc._pack_x_rows, inception._requant_batch)
    split = cs.phase_split(inception, params, x, wpack, "cpu", cfg)
    assert (inception.nc_forward, nc.nc_conv2d, bs.packed_dot_words,
            nc._pack_x_rows, inception._requant_batch) == attrs
    assert list(split) == ["pack", "dot", "minmax tree", "requant", "other"]
    assert all(v > 0 for k, v in split.items() if k != "other")
    assert split["other"] > -1e-3
    spans = tracing.last_session().totals()
    assert split["dot"] == spans["dot"]["total_s"]
    assert split["requant"] == pytest.approx(
        spans["epilogue.requant"]["total_s"] + spans["concat"]["total_s"])
