"""The window's arithmetic, the spans' self times and the trace reading, on
fakes with fixed times."""
import numpy as np
import pytest
import torch

from ncbench import harness, spans, trace

CPU = torch.device("cpu")


class FakeClock:
    def __init__(self):
        self.ns = 10 ** 12

    def __call__(self):
        return self.ns


class FakeEngine:
    """Serves whatever is queued; each step advances the clock by the next
    of ``walls`` seconds."""

    def __init__(self, clock, walls):
        self.clock, self.walls, self.queue, self.steps = clock, walls, [], 0
        self.completed = []

    def submit(self, req):
        self.queue.append(req)

    def step(self):
        self.clock.ns += int(self.walls[self.steps % len(self.walls)] * 1e9)
        self.completed += self.queue
        self.queue.clear()
        self.steps += 1


class FakeBuilder:
    @staticmethod
    def make_images(cfg, n, gen, device):
        return [None] * n

    @staticmethod
    def request(rid, image):
        return rid

    @staticmethod
    def collect(engine, batch):
        assert engine.completed == batch
        engine.completed.clear()
        return [(True, rid) for rid in batch]


@pytest.mark.parametrize("walls, seconds, batches", [
    ([10.0], 51, 6),  # 50 s is short of the deadline: a sixth batch runs
    ([17.0], 51, 3),  # the third ends on the deadline
    ([12.0, 20.0], 51, 4),  # the batch that crosses 51 s counts whole
    ([60.0], 51, 1),
])
def test_window_counts_whole_batches(monkeypatch, walls, seconds, batches):
    clock = FakeClock()
    monkeypatch.setattr(harness.time, "perf_counter_ns", clock)
    engine = FakeEngine(clock, walls)
    answers, got_walls, t0, t1 = harness.serve_window(
        engine, FakeBuilder, {"img": 1}, {"batch": 4}, 7, CPU, seconds)
    assert len(got_walls) == batches and len(answers) == 4 * batches
    assert [a[3] for a in answers] == list(range(4 * batches))
    assert [a[:2] for a in answers[-4:]] == [(batches - 1, j)
                                             for j in range(4)]
    assert got_walls == [walls[i % len(walls)] for i in range(batches)]
    window = (t1 - t0) / 1e9
    assert window == pytest.approx(sum(got_walls))
    assert window >= seconds
    # the rate: every image of every batch over the whole window
    assert len(answers) / window == pytest.approx(
        4 * batches / sum(got_walls))
    assert not engine.queue and not engine.completed


def test_span_self_times_and_segments(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(spans.time, "perf_counter_ns", clock)
    rec = spans.SpanRecorder(CPU)
    with rec.span("serve"):
        clock.ns += 1_000
        with rec.span("forward"):
            clock.ns += 2_000
            with rec.span("layer"):
                clock.ns += 3_000
            with rec.span("minmax"):
                clock.ns += 4_000
        clock.ns += 500
    tot = rec.totals()
    assert tot["serve"]["total_s"] == pytest.approx(10.5e-6)
    assert tot["serve"]["self_s"] == pytest.approx(1.5e-6)
    assert tot["forward"]["self_s"] == pytest.approx(2e-6)
    assert tot["layer"]["self_s"] == pytest.approx(3e-6)
    seg = rec.segments()
    assert [s[2] for s in seg] == ["serve", "forward", "layer", "minmax",
                                   "serve"]
    assert sum(b - a for a, b, _ in seg) == 10_500


def test_patched_wraps_module_calls_and_restores():
    from repro_torch.core import bitserial

    real = bitserial.packed_dot_words
    rec = spans.SpanRecorder(CPU)
    with rec.patched([("dot", "repro_torch.core.bitserial:packed_dot_words")]):
        assert bitserial.packed_dot_words is not real
    assert bitserial.packed_dot_words is real


def test_trace_summary_busy_ops_and_idle_by_span():
    tr = dict(starts=np.array([100, 200, 250, 700], np.int64),
              ends=np.array([150, 260, 300, 800], np.int64),
              names=["a", "b", "a", "c"], offset_ns=0)
    segments = [(0, 400, "forward"), (400, 1000, "minmax")]
    s = trace.summarize(tr, 0, 1000, segments)
    assert s["busy_s"] == pytest.approx(250e-9)  # 50 + 100 + 100
    assert s["kernel_s"]["a"] == pytest.approx(100e-9)
    assert s["device_ops"][0][0] in ("a", "c")
    idle = dict(s["idle_gaps"])
    # gaps: [0,100] [150,200] [300,700] [800,1000]
    assert idle["forward"] == pytest.approx(150e-9)
    assert idle["minmax"] == pytest.approx(600e-9)
    # a clock offset moves the trace onto the host clock
    tr["offset_ns"] = 100
    assert trace.summarize(tr, 0, 1000, segments)["busy_s"] == \
        pytest.approx(250e-9)
