"""The port's sharding rules against ``repro.distributed.sharding``.

For every config, every parameter leaf (paths and shapes from the
reference's ``jax.eval_shape(init_lm)``) and both production meshes,
``(16, 16)`` and ``(2, 16, 16)`` (axis names and sizes only, the
reference's ``FakeMesh`` stand-in): ``spec_for_param``, the
``ShardingReport`` (assigned specs and fallbacks, in leaf order),
``plan_parallelism``, ``_batch_spec`` / ``make_batch_sharding`` for every
shape and ``make_cache_shardings`` for every decode shape equal the
reference's.  ``to_placements`` gives, on a fake world of 256 ranks, local
shard shapes equal to the spec's arithmetic.
"""
import jax
import numpy as np
import pytest
import torch

import repro.distributed.sharding as RSh
from repro.configs import REGISTRY as RREG
from repro.configs import get_config as rget
from repro.configs import shapes_for as rshapes
from repro.configs.base import ShapeSpec as RShape
from repro.models import transformer as RT
from repro_torch.configs import get_config as tget
from repro_torch.configs import shapes_for as tshapes
from repro_torch.distributed import sharding as TSh
from repro_torch.launch import steps as S

torch.set_num_threads(1)


class FakeMesh:
    """The reference's mesh stand-in: axis names + shape only."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


MESHES = {
    "pod16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _meshes(name):
    shape, axes = MESHES[name]
    return FakeMesh(shape, axes), TSh.AbstractMesh(shape, axes)


@pytest.fixture
def ref_named(monkeypatch):
    """The reference's ``NamedSharding`` needs a device mesh; over the
    stand-in a (mesh, spec) pair records the same spec."""
    monkeypatch.setattr(RSh, "NamedSharding",
                        lambda mesh, spec: (mesh, tuple(spec)))


def _ref_leaves(cfg):
    abs_params = jax.eval_shape(lambda: RT.init_lm(cfg, jax.random.key(0)))
    flat, _ = jax.tree_util.tree_flatten_with_path(abs_params)
    return [(RSh._path_str(p), tuple(x.shape)) for p, x in flat]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(RREG))
def test_param_specs_and_report_equal_reference(arch, mesh):
    rmesh, tmesh = _meshes(mesh)
    rcfg, tcfg = rget(arch), tget(arch)
    rrep = RSh.ShardingReport()
    want = {}
    for path, shape in _ref_leaves(rcfg):
        spec = RSh.spec_for_param(path, shape, rcfg, rmesh, rrep)
        rrep.note(path, spec)
        want[path] = tuple(spec)
    trep = TSh.ShardingReport()
    got = TSh.make_param_shardings(tcfg, tmesh, S.abstract_params(tcfg), trep)
    from repro_torch import tree
    got_specs = dict(zip(
        [p for p in trep.assigned], [sh.spec for sh in tree.leaves(got)]))
    assert got_specs == want
    assert trep.assigned == rrep.assigned
    assert trep.fallbacks == rrep.fallbacks
    for path, shape in _ref_leaves(rcfg):  # and leaf by leaf, no report
        assert TSh.spec_for_param(path, shape, tcfg, tmesh) == want[path]


@pytest.mark.parametrize("arch", sorted(RREG))
def test_plan_parallelism_equals_reference(arch):
    assert TSh.plan_parallelism(tget(arch)) == RSh.plan_parallelism(
        rget(arch))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(RREG))
def test_batch_specs_equal_reference(arch, mesh, ref_named):
    rmesh, tmesh = _meshes(mesh)
    rcfg, tcfg = rget(arch), tget(arch)
    for rs, ts in zip(rshapes(rcfg), tshapes(tcfg)):
        assert rs.name == ts.name
        for mode in ("tp", "fsdp", "ep"):
            rr, tr = RSh.ShardingReport(), TSh.ShardingReport()
            assert (TSh._batch_spec(ts.global_batch, tmesh, tr, "w", mode)
                    == RSh._batch_spec(rs.global_batch, rmesh, rr, "w",
                                       mode))
            assert tr.fallbacks == rr.fallbacks
        rr, tr = RSh.ShardingReport(), TSh.ShardingReport()
        _, rspec = RSh.make_batch_sharding(rcfg, rmesh, rs, rr)
        tsh = TSh.make_batch_sharding(tcfg, tmesh, ts, tr)
        assert tsh.spec == rspec
        assert tr.fallbacks == rr.fallbacks
    # batch of one (sequence sharding) and an indivisible batch
    for b, seq, kind in ((1, 4096, "prefill"), (1, 1, "decode"),
                         (3, 64, "train")):
        _, rspec = RSh.make_batch_sharding(rcfg, rmesh,
                                           RShape("x", seq, b, kind))
        assert TSh.make_batch_sharding(
            tcfg, tmesh, S.ShapeSpec("x", seq, b, kind)).spec == rspec


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(RREG))
def test_cache_specs_equal_reference(arch, mesh, ref_named):
    rmesh, tmesh = _meshes(mesh)
    rcfg, tcfg = rget(arch), tget(arch)
    for rs, ts in zip(rshapes(rcfg), tshapes(tcfg)):
        if rs.kind != "decode":
            continue
        caches = jax.eval_shape(
            lambda: RT.init_caches(rcfg, rs.global_batch, rs.seq_len))
        rr, tr = RSh.ShardingReport(), TSh.ShardingReport()
        want = [spec for _, spec in jax.tree.leaves(
            RSh.make_cache_shardings(rcfg, rmesh, rs, caches, rr),
            is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], FakeMesh))]
        from repro_torch import tree
        got = [sh.spec for sh in tree.leaves(TSh.make_cache_shardings(
            tcfg, tmesh, ts, S.abstract_caches(tcfg, ts), tr))]
        assert got == want
        assert tr.assigned == rr.assigned
        assert tr.fallbacks == rr.fallbacks


def test_spec_str_is_partition_spec_str():
    P = jax.sharding.PartitionSpec
    for spec in ((), (None, None), ("data", None),
                 (("pod", "data"), None, "model"), (None, ("model", "data"))):
        assert TSh.spec_str(spec) == str(P(*spec))


@pytest.mark.parametrize("arch", ["olmo-1b", "moonshot-v1-16b-a3b",
                                  "hymba-1.5b", "qwen1.5-110b"])
def test_to_placements_local_shapes_on_fake_world(arch):
    """Every parameter leaf distributed on a (16, 16) fake world of meta
    tensors: its local shard is the spec's arithmetic (each named dim
    divided by the product of its axes' sizes)."""
    from repro_torch import tree
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    cfg = tget(arch)
    params = S.abstract_params(cfg)
    sizes = {"data": 16, "model": 16}
    with fake_world(256):
        mesh = make_production_mesh()
        shardings = TSh.make_param_shardings(cfg, mesh, params)
        for x, sh in zip(tree.leaves(params), tree.leaves(shardings)):
            want = list(x.shape)
            for d, entry in enumerate(sh.spec):
                for a in (entry if isinstance(entry, tuple) else
                          (entry,) if entry else ()):
                    want[d] //= sizes[a]
            local = TSh.distribute(x, sh).to_local()
            assert tuple(local.shape) == tuple(want), sh.spec


def test_to_placements_inverts_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = TSh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert TSh.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert TSh.to_placements((None, None), mesh) == (Replicate(),) * 3
    assert TSh.to_placements(((), "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        TSh.to_placements(("model", "model"), mesh)
