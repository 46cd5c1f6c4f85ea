"""The port's dry run and report against ``repro.launch.dryrun`` and
``repro.launch.report``.

* ``run_cell`` on a fake (2, 2) world of a reduced olmo cell (train and
  prefill) writes the reference's keys, and its ``argument_size_in_bytes``
  (the local shard bytes of parameters, optimizer state and batch) equals
  the reference's ``memory_analysis()`` of the same reduced cell compiled
  on a (2, 2) mesh of 4 host devices (a subprocess running the reference's
  own ``run_cell`` with its config, shape and mesh swapped for the reduced
  ones).
* ``report.py``'s tables equal the reference's on the same records, apart
  from the capacity column's header (the H100's 80 GiB) and the advice
  column of the roofline table (worded for the card).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.launch import report as RRep
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as TD
from repro_torch.launch import report as TRep

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {"train_4k": (64, 4, "train"), "prefill_32k": (64, 2, "prefill")}

_REF = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import repro.launch.dryrun as D
    from repro.configs import get_config, reduced_config
    from repro.configs.base import ShapeSpec
    from repro.launch.mesh import make_mesh_compat
    cells = json.loads(sys.argv[1])
    D.get_config = lambda a: reduced_config(get_config(a))
    D.SHAPES = {k: ShapeSpec(k, *v) for k, v in cells.items()}
    D.make_production_mesh = lambda multi_pod=False: make_mesh_compat(
        (2, 2), ("data", "model"))
    out = {k: D.run_cell("olmo-1b", k, False) for k in cells}
    print("REC", json.dumps(out, default=str))
""")


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, json.dumps(CELLS)],
                       env=env, capture_output=True, text=True, timeout=120,
                       cwd=ROOT)
    line = [l for l in r.stdout.splitlines() if l.startswith("REC ")]
    assert line, r.stdout + r.stderr[-4000:]
    ref = json.loads(line[0][4:])
    cfg = reduced_config(get_config("olmo-1b"))
    port = {k: TD.run_cell("olmo-1b", k, False, cfg=cfg,
                           spec=ShapeSpec(k, *v), mesh_shape=(2, 2))
            for k, v in CELLS.items()}
    return ref, port


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_run_cell_keys_and_argument_bytes_equal_reference(records, cell):
    ref, port = records
    r, p = ref[cell], port[cell]
    assert set(p) == set(r)
    assert set(p["memory_analysis"]) == set(r["memory_analysis"])
    assert set(p["roofline"]) == set(r["roofline"])
    assert (p["memory_analysis"]["argument_size_in_bytes"]
            == r["memory_analysis"]["argument_size_in_bytes"])
    assert p["kind"] == r["kind"] and p["chips"] == r["chips"] == 4
    assert p["sharding_fallbacks"] == r["sharding_fallbacks"]
    assert p["roofline"]["model_flops_total"] == \
        r["roofline"]["model_flops_total"]
    assert p["fits_hbm"] and p["roofline"]["hlo_flops_per_device"] > 0


def _strip(table: str, drop_last: bool) -> list[str]:
    rows = []
    for i, line in enumerate(table.splitlines()):
        cells = line.split("|")
        if i == 0:
            cells = [c for c in cells if "fits" not in c]
        if drop_last and i > 1:
            cells = cells[:-2]
        rows.append("|".join(cells))
    return rows


def test_report_tables_equal_reference(records):
    _, port = records
    recs = []
    for mesh in ("pod16x16", "pod2x16x16"):
        for rec in port.values():
            recs.append(dict(rec, mesh=mesh, ok=True))
    recs.append({"arch": "x", "shape": "y", "mesh": "pod16x16", "ok": False,
                 "error": "RuntimeError: boom"})
    got, want = TRep.dryrun_table(recs), RRep.dryrun_table(recs)
    assert "fits 80 GiB" in got.splitlines()[0]
    assert _strip(got, False) == _strip(want, False)
    got, want = TRep.roofline_table(recs), RRep.roofline_table(recs)
    assert len(got.splitlines()) == len(want.splitlines()) == 4
    assert _strip(got, True) == _strip(want, True)
    assert "80 GiB" in TRep.summary(recs)
