"""The cell ``inception_v3-hostq.serve4`` at test size on the CPU: the
engine's default batch of 4 through the window's loop, answered exactly
as the plain reference computes, and read by the metrics that list it."""
import copy
import json

import pytest
import torch

from ncbench import conftest, harness
from ncbench.builders import inception as builder

CPU = torch.device("cpu")
CELL = "inception_v3-hostq.serve4"


@pytest.fixture(scope="module")
def window():
    """One served tiny window of the cell at its own batch, recorded under
    a CPU ``torch.profiler`` session as the traced run records it."""
    from torch.profiler import ProfilerActivity, profile

    from ncbench.references import inception as ref

    manifest = json.loads((conftest.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell.find(copy.deepcopy(manifest), CELL, conftest.ROOT)
    cell.config.update(conftest.TINY)
    params = builder.make_params(cell.config,
                                 torch.Generator().manual_seed(4), CPU)
    engine = builder.build_engine(params, cell.config, cell.traffic, CPU)
    with profile(activities=[ProfilerActivity.CPU]):
        answers, walls, t0, t1 = harness.serve_window(
            engine, builder, cell.config, cell.traffic, 9, CPU, 0)
    ctx = dict(config=cell.config, traffic=cell.traffic, images=len(answers),
               batches=len(walls), window_s=(t1 - t0) / 1e9, spans={},
               kernel_s={}, busy_s=0.0)
    # the readings, while the window's session is the last
    values = {m["name"]: harness.read_metric(m["name"], ctx)
              for m in cell.per_layer()}
    checks, n = harness.check(cell, params, answers, 9, CPU, builder, ref)
    return cell, ctx, checks, n, values


def test_the_cell_serves_batches_of_four(window):
    cell, ctx, checks, n, _ = window
    assert cell.traffic["batch"] == 4 and cell.workload["chips"] == 1
    assert ctx["batches"] == 1 and ctx["images"] == 4
    assert n == 4  # the whole batch checked (sample 16)
    assert checks["logit_gap"] == (0.0, 0.0)
    assert checks["failed_requests"] == (0, 0)


def test_the_cell_is_read_by_the_inception_metrics_but_the_minmax(window):
    cell, ctx, _, _, values = window
    names = set(values)
    assert "bitserial.minmax_s_per_image" not in names
    assert {"serve.self_s_per_image", "kernels.dot_roofline",
            "device.idle_share", "device.mfu",
            "forward.host_syncs_per_image"} <= names
    assert not any(n.startswith(("lm.", "kernels.flash")) for n in names)
    for name in ("forward.requant_s_per_image", "forward.host_syncs_per_image",
                 "forward.concat_s_per_image"):
        assert values[name] > 0, name
