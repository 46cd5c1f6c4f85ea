"""The six readers of the program's own spans and counters
(``ncbench/program.py``), on a served tiny window recorded under a CPU
``torch.profiler`` session, as the traced run records its window."""
import copy
import json

import pytest
import torch

from ncbench import conftest, harness
from ncbench.builders import inception as builder

CPU = torch.device("cpu")
READERS = ["forward.requant_s_per_image", "forward.minmax_pack_s_per_image",
           "forward.concat_s_per_image", "forward.pool_s_per_image",
           "forward.host_syncs_per_image", "forward.host_wait_s_per_image"]
CELLS = ["inception_v3-hostq.throughput",
         "inception_v3-pruned50-hostq.throughput"]


@pytest.fixture(scope="module")
def windows():
    """``windows(name)``: the reader context of one served tiny window of
    cell ``name``, recorded once."""
    from torch.profiler import ProfilerActivity, profile

    cache = {}

    def get(name):
        if name not in cache:
            manifest = json.loads((conftest.ROOT / "BENCHMARK.json")
                                  .read_text())
            cell = harness.Cell.find(copy.deepcopy(manifest), name,
                                     conftest.ROOT)
            cell.config.update(conftest.TINY)
            traffic = dict(cell.traffic, batch=2)
            params = builder.make_params(
                cell.config, torch.Generator().manual_seed(3), CPU)
            engine = builder.build_engine(params, cell.config, traffic, CPU)
            with profile(activities=[ProfilerActivity.CPU]):
                answers, walls, t0, t1 = harness.serve_window(
                    engine, builder, cell.config, traffic, 7, CPU, 0)
            ctx = dict(config=cell.config, traffic=traffic,
                       images=len(answers), batches=len(walls),
                       window_s=(t1 - t0) / 1e9, spans={}, kernel_s={},
                       busy_s=0.0)
            values = {m: harness.read_metric(m, ctx) for m in READERS}
            cache[name] = ctx, values
        return cache[name]
    return get


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("name", CELLS)
def test_reader_reads_the_window(windows, name, reader):
    ctx, values = windows(name)
    assert ctx["batches"] == 1 and ctx["images"] == 2
    assert values[reader] is not None and values[reader] > 0


@pytest.mark.parametrize("name", CELLS)
def test_host_syncs_are_a_whole_count_per_batch(windows, name):
    ctx, values = windows(name)
    per_batch = values["forward.host_syncs_per_image"] * ctx["images"]
    assert per_batch == int(per_batch) > 0


def test_readers_find_nothing_in_another_window(windows):
    ctx, _ = windows(CELLS[0])
    for other in (dict(ctx, batches=ctx["batches"] + 1), dict(ctx, images=0)):
        for reader in READERS:
            assert harness.read_metric(reader, other) is None, reader
