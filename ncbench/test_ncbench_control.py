"""The check's control and faults: whole runs of a test-sized cell on the
CPU, the program's timed path broken underneath, must come out not
correct; the sound run must come out correct."""
import time

import pytest
import torch

from ncbench import harness
from ncbench.references import inception as ref

CPU = torch.device("cpu")
CELLS = ["inception_v3-hostq.throughput",
         "inception_v3-pruned50-hostq.throughput"]


def _run(cell, seed=2 ** 31 + 5):
    return harness.run(cell, seed, 0.0, False, CPU, time.perf_counter())


def _wrap_forward(monkeypatch, change):
    from repro_torch.models import inception

    real = inception.nc_forward

    def forward(params, x, **kw):
        logits, report = real(params, x, **kw)
        return change(params, x, kw, logits), report
    monkeypatch.setattr(inception, "nc_forward", forward)


def _control(cfg):
    """The reference at four bits in the program's place."""
    def change(params, x, kw, logits):
        return ref.logits(params, x, cfg, bits=4)
    return change


def _one_logit_nudged(params, x, kw, logits):
    out = logits.clone()
    out[-1, 0] = torch.nextafter(out[-1, 0], torch.tensor(float("inf")))
    return out


def _rows_shifted(params, x, kw, logits):
    return logits.roll(1, dims=0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    res = _run(tiny_cell(name))
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["logit_gap"] == {"value": 0.0, "limit": 0.0}
    assert set(res["metrics"]) == {"images_per_s", "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"


def test_traced_run_reads_the_span_metrics(tiny_cell):
    """On the CPU the spans are read and the device metrics, with no trace
    to read, are left out."""
    res = harness.run(tiny_cell(CELLS[1]), 11, 0.0, True, CPU,
                      time.perf_counter())
    assert res["correct"]
    assert set(res["metrics"]) == {
        "serve.self_s_per_image", "forward.self_s_per_image",
        "nc_layers.pack_s_per_image", "bitserial.minmax_s_per_image",
        "bitserial.dot_s_per_image"}
    assert all(m["value"] > 0 for name, m in res["metrics"].items()
               if name != "serve.self_s_per_image")
    assert res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("fault", ["control_int4", "answer_altered",
                                   "rows_shifted", "dot_altered"])
def test_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, fault):
    cell = tiny_cell(CELLS[0])
    if fault == "dot_altered":  # one integer of every dot, where produced
        from repro_torch.core import bitserial

        real = bitserial.packed_dot_words

        def dot(*a, **k):
            vals, cycles = real(*a, **k)
            vals = vals.clone(memory_format=torch.contiguous_format)
            vals.view(-1)[0] += 1
            return vals, cycles
        monkeypatch.setattr(bitserial, "packed_dot_words", dot)
    else:
        _wrap_forward(monkeypatch, {
            "control_int4": _control(cell.config),
            "answer_altered": _one_logit_nudged,
            "rows_shifted": _rows_shifted}[fault])
    res = _run(cell)
    assert not res["correct"] and res["failed"] == 0
    assert 0.0 < res["checks"]["logit_gap"]["value"] < float("inf")
