"""The cell ``granite-4.0-h-small-ep8.decode256`` at test size on the CPU:
its files, one served window through the harness's loop and check, the
control's gap, and the new readers on the program's session."""
import copy
import json
import pathlib
import sys

import pytest
import torch

from ncbench import conftest, harness, program_lm, roofline_lm
from ncbench.builders import granite as builder
from ncbench.references import granite as ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT / "tests") not in sys.path:
    sys.path.insert(0, str(ROOT / "tests"))

from granite_cases import TINY, TRAFFIC  # noqa: E402

CPU = torch.device("cpu")
CELL = "granite-4.0-h-small-ep8.decode256"
READERS = ["lm.prefill_s_per_request", "lm.decode_s_per_request",
           "lm.mamba_s_per_request", "lm.attn_s_per_request",
           "lm.moe_s_per_request", "lm.host_syncs_per_request", "lm.mfu"]


@pytest.fixture(scope="module")
def window():
    """One served tiny window of the cell, recorded in a tracing session,
    and its check."""
    from repro_torch import tracing

    manifest = json.loads((conftest.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell.find(copy.deepcopy(manifest), CELL, conftest.ROOT)
    cell.config.update(TINY)
    cell.config["check"]["steps"] = [0, 4, 8]
    cell.traffic = dict(cell.traffic, **TRAFFIC)
    params = builder.make_params(cell.config,
                                 torch.Generator().manual_seed(2 ** 31 + 5),
                                 CPU)
    engine = builder.build_engine(params, cell.config, cell.traffic, CPU)
    with tracing.session():
        answers, walls, t0, t1 = harness.serve_window(
            engine, builder, cell.config, cell.traffic, 2 ** 31 + 9, CPU, 0)
    ctx = dict(config=cell.config, traffic=cell.traffic, images=len(answers),
               batches=len(walls), window_s=(t1 - t0) / 1e9, spans={},
               kernel_s={}, busy_s=0.0)
    # the readings, while the window's session is the last
    values = {name: harness.read_metric(name, ctx) for name in READERS}
    counters = program_lm.counters(ctx)
    checks, n = harness.check(cell, params, answers, 2 ** 31 + 9, CPU,
                              builder, ref)
    return cell, params, ctx, checks, n, values, counters


def test_the_cell_finds_its_files_and_keeps_the_published_config(manifest):
    cell = harness.Cell.find(manifest, CELL, conftest.ROOT)
    cfg = cell.config
    assert cell.workload["chips"] == 1
    assert cell.traffic["batch"] == 64 and cell.traffic["continuation"] == 256
    # the prefill's last position and every 16th decode step, 128 and 256
    # among them; 32 requests of a window: 544 kept rows compared
    assert cfg["check"]["steps"] == list(range(0, 257, 16))
    assert cfg["check"]["sample"] * len(cfg["check"]["steps"]) >= 500
    entry = {c["name"]: c for c in manifest["configs"]}[
        cell.workload["config"]]
    assert entry["reduced"] == ["num_local_experts"]
    assert cfg["num_local_experts"] * cfg["expert_parallel"] \
        == cfg["experts_published"] == 72
    assert {m["name"] for m in cell.end_to_end()} == {
        "images_per_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer()} == set(READERS) | {
        "kernels.flash_roofline", "device.idle_share"}


def test_one_window_is_served_and_checked(window):
    cell, _, ctx, checks, n, _, _ = window
    assert ctx["batches"] == 1 and ctx["images"] == TRAFFIC["batch"]
    assert n == TRAFFIC["batch"]
    gap, _ = checks["logit_gap"]
    assert gap < 2e-6  # float32 program at test size: rounding alone
    assert checks["failed_requests"] == (0, 0)


def test_the_control_reads_a_larger_gap(window):
    """The reference with its weights rounded to float8 e4m3 misses the
    float32 reference by far more than the program does."""
    cell, params, _, checks, _, _, _ = window
    rows = harness.batch_images(builder, cell.config, 2 ** 31 + 9, 0,
                                TRAFFIC["batch"], CPU)
    want = ref.logits(params, rows, cell.config)
    ctl = ref.logits(params, rows, cell.config, bits=8)
    assert (ctl - want).abs().max() > 100 * checks["logit_gap"][0]


def test_the_readers_read_the_window(window):
    cell, _, ctx, _, _, values, c = window
    for name in READERS:
        assert values[name] is not None and values[name] > 0, name
    assert c["moe.dropped"] == 0 and c["moe.assigned"] > 0
    assert c["tokens.decode"] == TRAFFIC["batch"] * TRAFFIC["continuation"]


def test_the_flash_roofline_is_the_least_time_over_the_kernel(
        window, monkeypatch):
    """The kernel's reading needs the card's trace; given a device time
    it is the least time over it."""
    cell, _, ctx, _, _, _, c = window
    monkeypatch.setattr(program_lm, "counters", lambda ctx: c)
    kctx = dict(ctx, kernel_s={"void (anonymous namespace)::tc::kernel<16>":
                               1.0})
    assert harness.read_metric("kernels.flash_roofline", kctx) == \
        pytest.approx(100 * roofline_lm.flash_least_s(
            cell.config, c["attn.prefill_pairs"], c["tokens.prefill"]))


def test_the_readers_read_nothing_without_the_programs_session(window):
    """Each test starts with no session (the root ``conftest.py``)."""
    cell, _, ctx, _, _, _, _ = window
    for name in READERS + ["kernels.flash_roofline"]:
        assert harness.read_metric(name, ctx) is None, name


def test_model_flops_at_the_published_shapes():
    """Per token, the layers every token takes: 36 Mamba layers' 102.2 M
    projection weights, 4 attention layers' 41.9 M, 40 routers and shared
    experts' 19.2 M: 2 x 4.6 G."""
    cfg = json.loads((ROOT / "ncbench/configs/granite-4.0-h-small-ep8.json")
                     .read_text())
    per = roofline_lm.dense_flops_per_token(cfg)
    assert per == 2 * (36 * (4096 * 16768 + 8192 * 4096)
                       + 4 * (2 * 4096 * 4096 + 2 * 4096 * 1024)
                       + 40 * (4096 * 72 + 3 * 4096 * 1536))
    assert round(per / 2e9, 2) == 4.62
