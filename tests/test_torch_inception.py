"""The port's Inception v3 against the JAX reference, with the reference's
weights carried across by ``params_from_jax``.

``nc_forward`` logits must be byte-identical (float32 bit patterns) and
every ``NCLayerReport`` equal, at batch 1 and 2.  The float ``apply`` is
compared with a stated tolerance: both run float32 convolutions, whose sums
are taken in different orders (atol 1e-4 on logits of magnitude ~1).
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import faults as rfaults
from repro.core import schedule as rsched
from repro.core.cache_geometry import XEON_E5_35MB as RGEOM
from repro.models import inception as ri
from repro_torch.core import faults as tfaults
from repro_torch.core import schedule as tsched
from repro_torch.core.cache_geometry import XEON_E5_35MB as TGEOM
from repro_torch.models import inception as ti

torch.set_num_threads(1)

TINY = {
    "stem": dict(img=31, width_div=8, classes=8, stages=()),
    "mixed_a": dict(img=47, width_div=8, classes=8, stages=("a",)),
}


@pytest.fixture(scope="module", params=sorted(TINY))
def tiny(request):
    kw = TINY[request.param]
    rc, tc = ri.reduced_config(**kw), ti.reduced_config(**kw)
    params = ri.init_params(jax.random.key(0), config=rc)
    return rc, tc, params, ti.params_from_jax(params, device="cpu")


def _same_forward(a, b):
    (la, ra), (lb, rb) = a, b
    la = np.asarray(la)
    assert lb.dtype == torch.float32 and la.shape == tuple(lb.shape)
    assert (la.view(np.uint32) == lb.numpy().view(np.uint32)).all()
    assert dataclasses.asdict(ra) == dataclasses.asdict(rb)


@pytest.mark.parametrize("batch", [1, 2])
def test_nc_forward_byte_identical(tiny, batch):
    rc, tc, rparams, tparams = tiny
    x = np.random.default_rng(batch).random((batch, rc.img, rc.img, 3),
                                            dtype=np.float32)
    want = ri.nc_forward(rparams, x, config=rc, engine="jit")
    _same_forward(want, ti.nc_forward(tparams, x, config=tc, device="cpu"))


def test_nc_forward_walk_sparse_and_unbatched(tiny):
    """The walk backend, a sparse plan and an unbatched image give the same
    logits and reports as the reference."""
    rc, tc, rparams, tparams = tiny
    x = np.random.default_rng(5).random((rc.img, rc.img, 3), dtype=np.float32)
    want = ri.nc_forward(rparams, x, config=rc, engine="jit", sparse=True)
    got = ti.nc_forward(tparams, torch.from_numpy(x), config=tc,
                        engine="walk", sparse=True, device="cpu")
    _same_forward(want, got)


def test_nc_forward_pruned_schedule(tiny):
    """Half the filters pruned, planned through an explicit sparse schedule
    (the serving path)."""
    rc, tc, rparams, tparams = tiny
    r_wpack = ri.prune_wpack(ri.prepare_conv_weights(rparams, rc))
    t_wpack = ti.prune_wpack(ti.prepare_conv_weights(tparams, tc))
    r_sched = rsched.plan_network(ri.inception_v3_specs(rc), batch=2,
                                  occupancy=ri.network_occupancy(r_wpack, rc),
                                  overlap=True)
    t_sched = tsched.plan_network(ti.inception_v3_specs(tc), batch=2,
                                  occupancy=ti.network_occupancy(t_wpack, tc),
                                  overlap=True)
    assert dataclasses.asdict(r_sched) == dataclasses.asdict(t_sched)
    x = np.random.default_rng(6).random((2, rc.img, rc.img, 3),
                                        dtype=np.float32)
    want = ri.nc_forward(rparams, x, config=rc, engine="jit",
                         schedule=r_sched, wpack=r_wpack)
    got = ti.nc_forward(tparams, x, config=tc, schedule=t_sched,
                        wpack=t_wpack, device="cpu")
    _same_forward(want, got)


FAULTS = "seed=2,filter=0.4,act=0.2,compute=0.4,stuck=3"


@pytest.mark.parametrize("overlap", [False, True])
def test_nc_forward_integrity_compressed_under_faults(tiny, overlap):
    """A checked, compressed batch-2 forward under an active fault profile:
    logits and every layer report equal the reference's, the fault ledgers
    are equal event for event, nothing corrupt went undetected, and the
    logits equal the clean unchecked run's."""
    rc, tc, rparams, tparams = tiny
    x = np.random.default_rng(8).random((2, rc.img, rc.img, 3),
                                        dtype=np.float32)
    kw = dict(integrity=True, compressed=True, overlap=overlap)
    with rfaults.inject(rfaults.FaultProfile.parse(FAULTS)) as rfs:
        want = ri.nc_forward(rparams, x, config=rc, engine="jit", **kw)
    with tfaults.inject(tfaults.FaultProfile.parse(FAULTS)) as tfs:
        got = ti.nc_forward(tparams, x, config=tc, device="cpu", **kw)
    _same_forward(want, got)
    assert rfs.stats() == tfs.stats() and rfs.events == tfs.events
    assert tfs.detected == tfs.corrupt_attempts > 0
    assert sum(r.reexec_passes for r in got[1].layers) == tfs.reexecuted
    clean, _ = ti.nc_forward(tparams, x, config=tc, device="cpu")
    assert torch.equal(clean.view(torch.int32), got[0].view(torch.int32))


def test_weights_and_occupancy_equal(tiny):
    rc, tc, rparams, tparams = tiny
    r_wpack = ri.prepare_conv_weights(rparams, rc)
    t_wpack = ti.prepare_conv_weights(tparams, tc)
    assert r_wpack.keys() == t_wpack.keys()
    for name, (wq, qp, bias) in r_wpack.items():
        twq, tqp, tbias = t_wpack[name]
        assert (np.asarray(wq) == twq.numpy()).all()
        assert np.float32(qp.scale) == tqp.scale
        assert int(qp.zero_point) == tqp.zero_point
        assert (np.asarray(bias) == tbias.numpy()).all()
    r_occ, t_occ = ri.network_occupancy(r_wpack, rc), ti.network_occupancy(t_wpack, tc)
    assert {k: dataclasses.asdict(v) for k, v in r_occ.items()} == \
        {k: dataclasses.asdict(v) for k, v in t_occ.items()}
    assert ri.activation_sparsity_estimates(rc) == ti.activation_sparsity_estimates(tc)


def test_float_apply_matches(tiny):
    rc, tc, rparams, tparams = tiny
    x = np.random.default_rng(7).random((2, rc.img, rc.img, 3),
                                        dtype=np.float32)
    want = np.asarray(ri.apply(rparams, x, config=rc))
    got = ti.apply(tparams, torch.from_numpy(x), config=tc).numpy()
    assert np.allclose(got, want, atol=1e-4, rtol=0)


def test_init_params_seeded_and_shaped():
    cfg = ti.reduced_config(**TINY["stem"])
    a = ti.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = ti.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    ref = ri.init_params(jax.random.key(0), config=ri.reduced_config(**TINY["stem"]))
    assert a.keys() == ref.keys()
    for name in a:
        assert torch.equal(a[name]["w"], b[name]["w"])
        assert tuple(a[name]["w"].shape) == ref[name]["w"].shape


def test_init_params_dtype_casts_the_float32_draw():
    """``dtype=`` casts the same seed's float32 draw; the default is that
    draw unchanged, bit for bit."""
    cfg = ti.reduced_config(**TINY["stem"])
    f32 = ti.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    dflt = ti.init_params(torch.Generator().manual_seed(3), cfg,
                          device="cpu", dtype=torch.float32)
    bf16 = ti.init_params(torch.Generator().manual_seed(3), cfg,
                          device="cpu", dtype=torch.bfloat16)
    for name in f32:
        for k in ("w", "scale", "bias"):
            assert torch.equal(dflt[name][k], f32[name][k])
            assert f32[name][k].dtype == torch.float32
            assert bf16[name][k].dtype == torch.bfloat16
            assert torch.equal(bf16[name][k], f32[name][k].to(torch.bfloat16))


@pytest.mark.parametrize("pruned", [False, True])
def test_forward_report_summary_equals_reference(pruned):
    """``NCForwardReport.summary()`` is the reference's text byte for byte:
    header, column widths, TOTAL and modeled-latency lines, and the sparse
    schedule line when pruned filters' passes were skipped (the mixed_a
    network on one slice, where its layers' passes serialize)."""
    rc, tc = (ri.reduced_config(**TINY["mixed_a"]),
              ti.reduced_config(**TINY["mixed_a"]))
    rparams = ri.init_params(jax.random.key(0), config=rc)
    tparams = ti.params_from_jax(rparams, device="cpu")
    x = np.random.default_rng(8).random((rc.img, rc.img, 3), dtype=np.float32)
    r_kw, t_kw = {}, {}
    if pruned:
        r_kw = dict(sparse=True, geom=RGEOM.scaled(1), wpack=ri.prune_wpack(
            ri.prepare_conv_weights(rparams, rc)))
        t_kw = dict(sparse=True, geom=TGEOM.scaled(1), wpack=ti.prune_wpack(
            ti.prepare_conv_weights(tparams, tc)))
    _, want = ri.nc_forward(rparams, x, config=rc, engine="jit", **r_kw)
    _, got = ti.nc_forward(tparams, x, config=tc, device="cpu", **t_kw)
    assert got.summary() == want.summary()
    assert (got.total_skipped_passes > 0) == pruned
    assert ("# sparse schedule:" in got.summary()) == pruned


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = ti.reduced_config(**TINY["stem"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ti.init_params(torch.Generator().manual_seed(0), cfg)
    params = ti.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    x = np.zeros((cfg.img, cfg.img, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ti.nc_forward(params, x, config=cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ti.nc_forward(params, x, config=cfg, device="cuda")


def test_unported_options_raise(tiny):
    """``stream_chunk``, integrity and compression beside an explicit
    schedule are ambiguous and raise, as in the reference."""
    rc, tc, _, tparams = tiny
    x = np.zeros((tc.img, tc.img, 3), np.float32)
    net = tsched.plan_network(ti.inception_v3_specs(tc), TGEOM, batch=1)
    with pytest.raises(ValueError, match="stream_chunk"):
        ti.nc_forward(tparams, x, config=tc, schedule=net, stream_chunk=1,
                      device="cpu")
    for flag in ("integrity", "compressed"):
        with pytest.raises(ValueError, match="schedule"):
            ti.nc_forward(tparams, x, config=tc, schedule=net, device="cpu",
                          **{flag: True})


def test_port_sources_import_neither_jax_nor_repro():
    """Parsed, not imported: no module of the port and not
    ``chip_smoke.py`` names ``jax``, ``jaxlib`` or ``repro`` in an import."""
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 15 and not bad, bad


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.device, "
            "repro_torch.core.backends, repro_torch.core.slo, "
            "repro_torch.models.inception, repro_torch.launch.serve, "
            "repro_torch.launch.engine_api, repro_torch.kernels.ops\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
