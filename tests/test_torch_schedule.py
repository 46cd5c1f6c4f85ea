"""The port's mapper, scheduler and simulator against the JAX reference.

Plans must be equal field for field, simulated results equal, and the
modeled cycles equal ``tests/golden/modeled_cycles.json`` (read only).
"""
import dataclasses
import json
import pathlib

import pytest
import torch

from repro.core import schedule as rsched
from repro.core import simulator as rsim
from repro.core.cache_geometry import XEON_E5_35MB as RGEOM
from repro.models import inception as ri
from repro_torch.core import schedule as tsched
from repro_torch.core import simulator as tsim
from repro_torch.core.cache_geometry import XEON_E5_35MB as TGEOM
from repro_torch.models import inception as ti

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "modeled_cycles.json"
CONFIGS = {"reduced": (ri.REDUCED, ti.REDUCED), "full": (ri.FULL, ti.FULL)}


_as_dict = dataclasses.asdict


def _occupancies(cfg_name):
    r_specs = ri.inception_v3_specs(CONFIGS[cfg_name][0])
    t_specs = ti.inception_v3_specs(CONFIGS[cfg_name][1])
    return (rsched.prune_occupancy(r_specs, 0.5),
            tsched.prune_occupancy(t_specs, 0.5))


@pytest.mark.parametrize("cfg_name", ["reduced", "full"])
def test_specs_equal(cfg_name):
    rc, tc = CONFIGS[cfg_name]
    assert rc.name == tc.name
    r_specs = [_as_dict(s) for s in ri.inception_v3_specs(rc)]
    t_specs = [_as_dict(s) for s in ti.inception_v3_specs(tc)]
    assert r_specs == t_specs


@pytest.mark.parametrize("cfg_name", ["reduced", "full"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
def test_plan_network_equal_field_for_field(cfg_name, batch, overlap, sparse):
    rc, tc = CONFIGS[cfg_name]
    r_occ, t_occ = _occupancies(cfg_name) if sparse else (None, None)
    r = rsched.plan_network(ri.inception_v3_specs(rc), RGEOM, batch=batch,
                            occupancy=r_occ, overlap=overlap)
    t = tsched.plan_network(ti.inception_v3_specs(tc), TGEOM, batch=batch,
                            occupancy=t_occ, overlap=overlap)
    assert _as_dict(r) == _as_dict(t)
    assert r.stream_batch_limit == t.stream_batch_limit
    assert r.residency_credit_bytes == t.residency_credit_bytes
    rr, tr = rsim.simulate_network(r), tsim.simulate_network(t)
    assert _as_dict(rr) == _as_dict(tr)
    assert rr.latency_s == tr.latency_s
    assert rsim.throughput(rr, batch) == tsim.throughput(tr, batch)


def test_plan_flags_ride_the_plan():
    """Integrity, compression and the backend pin are plan fields in the
    port too, equal to the reference's (their execution comes later)."""
    specs_r = ri.inception_v3_specs(ri.REDUCED)
    specs_t = ti.inception_v3_specs(ti.REDUCED)
    r = rsched.plan_network(specs_r, RGEOM, batch=2, integrity=True,
                            compressed=True)
    t = tsched.plan_network(specs_t, TGEOM, batch=2, integrity=True,
                            compressed=True)
    assert _as_dict(r) == _as_dict(t)
    assert tsched.plan_network(specs_t, TGEOM, backend="walk").backend == "walk"
    with pytest.raises(ValueError, match="gemm, walk"):
        tsched.plan_network(specs_t, TGEOM, backend="host")


def test_full_plan_shape():
    """The full network's plan: 95 conv/fc layers, largest K = 4032, 44,376
    planned tiles at batch 4 (the reference plans the same)."""
    t = tsched.plan_network(ti.inception_v3_specs(ti.FULL), TGEOM, batch=4)
    compute = [p for p in t.layers if p.spec.kind in ("conv", "fc")]
    assert len(compute) == 95
    assert max(p.spec.R * p.spec.S * p.spec.C for p in compute) == 4032
    rows = {p.spec.name: 4 * p.spec.E * p.spec.E for p in compute}
    tiles = sum(-(-rows[p.spec.name] // p.tile_rows)
                * -(-p.spec.M // p.tile_filters) for p in compute)
    assert tiles == 44376
    assert t.stream_batch_limit == 1


def test_golden_modeled_cycles():
    """The golden file's payload rebuilt from the port's planner and
    simulator (same recipe as tests/test_sparsity.py)."""
    cfg = ti.reduced_config()
    specs = ti.inception_v3_specs(cfg)
    occ = tsched.prune_occupancy(specs, 0.5)
    one_slice = TGEOM.scaled(1)

    def table(schedule, geom, keys):
        out = {}
        for p in schedule.layers:
            m = tsim.modeled_layer_cycles(p, geom)
            out[p.spec.name] = {k: conv(m[k]) for k, conv in keys.items()}
        return out

    dense_keys = {"per_pass_cycles": float, "serial_passes": int,
                  "skipped_passes": int, "total_cycles": float}
    overlap_keys = {"overlap": bool, "hidden_s": float,
                    "overlapped_total_s": float, "total_cycles": float}
    payload = {"config": cfg.name, "pruning": 0.5, "geometries": {}}
    for geom in (TGEOM, one_slice):
        payload["geometries"][geom.name] = {
            "dense": table(tsched.plan_network(specs, geom), geom, dense_keys),
            "pruned": table(tsched.plan_network(specs, geom, occupancy=occ),
                            geom, dense_keys),
            "overlapped": table(tsched.plan_network(specs, geom, overlap=True),
                                geom, overlap_keys),
        }
    assert payload == json.loads(GOLDEN.read_text())
