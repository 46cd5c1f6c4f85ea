"""The port's fault injection and ABFT integrity checking against the JAX
reference (``repro.core.faults``, the checked path of
``repro.core.nc_layers.nc_conv2d``).

Tolerance: none.  The same profile must corrupt the same words in both
packages; a checked ``nc_conv2d`` under each covered fault class must give
equal outputs, cycles, ``ConvStats`` (but ``engine_words_*``, which count
the ``walk`` multiplier's elision: ``walk``'s and ``SKIP_STATS`` are held
to ``host``'s in their own test, ``gemm``'s stay 0), ``FaultState.stats()``
and event log.  The port verifies all passes of a layer at once and re-runs
only the passes a fault hits; these tests hold its counters to the
reference's pass-by-pass loop.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitserial as rbs
from repro.core import faults as rfaults
from repro.core import nc_layers as rnc
from repro.core import quantize as rq
from repro.core.cache_geometry import XEON_E5_35MB as RGEOM
from repro_torch.core import bitserial as tbs
from repro_torch.core import faults as tfaults
from repro_torch.core import nc_layers as tnc
from repro_torch.core import quantize as tq
from repro_torch.core import schedule as tsched
from repro_torch.core.cache_geometry import XEON_E5_35MB as TGEOM

torch.set_num_threads(1)

UNCOUNTED = ("engine_words_total", "engine_words_skipped", "plan")
SPECS = ["seed=7,filter=0.05,act=0.01,compute=0.01,stuck=3",
         "seed=0", "stuck=2+5,stall=0.1:0.002,max_retries=2",
         "seed=3,filter=1,n_slices=4,stall=0.5"]


def _render(p):
    """A profile back in the CLI spec syntax."""
    fields = [f"seed={p.seed}", f"filter={p.filter_flip_rate}",
              f"act={p.act_flip_rate}", f"compute={p.compute_rate}",
              f"stall={p.stall_rate}:{p.stall_s}", f"n_slices={p.n_slices}",
              f"max_retries={p.max_retries}"]
    if p.stuck_slices:
        fields.append("stuck=" + "+".join(map(str, p.stuck_slices)))
    return ",".join(fields)


@pytest.mark.parametrize("spec", SPECS)
def test_profile_parse_roundtrip(spec):
    r, t = rfaults.FaultProfile.parse(spec), tfaults.FaultProfile.parse(spec)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    assert r.any_faults == t.any_faults
    assert tfaults.FaultProfile.parse(_render(t)) == t


@pytest.mark.parametrize("spec,match", [("filter=2", "outside"),
                                        ("bogus=1", "unknown"),
                                        ("seed", "key=value"),
                                        ("stuck=14", "out of range")])
def test_profile_validation_errors(spec, match):
    with pytest.raises(ValueError, match=match):
        rfaults.FaultProfile.parse(spec)
    with pytest.raises(ValueError, match=match):
        tfaults.FaultProfile.parse(spec)


def _word_grids(K, seed, T=6, M=4, bits=8):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << bits, size=(T, K))
    w = rng.integers(0, 1 << bits, size=(M, K))
    r = (rnc._pack_x_rows(x.astype(np.uint32), bits),
         rnc._pack_w_rows(w.astype(np.uint32), bits))
    t = (tnc._pack_x_rows(torch.from_numpy(x), bits),
         tnc._pack_w_rows(torch.from_numpy(w), bits))
    return r, t


@pytest.mark.parametrize("K", [40, 9])  # K = 9: rows share words
def test_same_profile_corrupts_same_words(K):
    prof = dict(seed=11, filter_flip_rate=0.6, act_flip_rate=0.6,
                compute_rate=0.6)
    probe = rfaults.FaultState(rfaults.FaultProfile())
    stuck = probe.slice_for("L", 0)
    rs = rfaults.FaultState(rfaults.FaultProfile(stuck_slices=(stuck,),
                                                 **prof))
    ts = tfaults.FaultState(tfaults.FaultProfile(stuck_slices=(stuck,),
                                                 **prof))
    P, _, r = rnc.bs._row_layout(K)
    lanes = np.arange(0, K, 2)
    fired = 0
    for t in range(12):
        (rx, rw), (tx, tw) = _word_grids(K, t)
        ro = rs.corrupt_filter_words(rw, "L", t, lanes=lanes, filters=3,
                                     P=P, r=r)
        to = ts.corrupt_filter_words(tw, "L", t, lanes=lanes, filters=3,
                                     P=P, r=r)
        assert (ro is rw) == (to is tw)
        assert (to.numpy() == ro.astype(np.int64)).all()
        ro = rs.corrupt_act_words(rx, "L", t, lanes=lanes, rows=5, P=P, r=r)
        to = ts.corrupt_act_words(tx, "L", t, lanes=lanes, rows=5, P=P, r=r)
        assert (ro is rx) == (to is tx)
        assert (to.numpy() == ro.astype(np.int64)).all()
        vals = np.arange(12, dtype=np.int64).reshape(3, 4)
        ro = rs.corrupt_values(vals, "L", t, filters=3, rows=4)
        to = ts.corrupt_values(torch.from_numpy(vals), "L", t, filters=3,
                               rows=4)
        assert (to.numpy() == ro).all()
        fired += ro is not vals
    assert fired and rs.events == ts.events
    assert rs.stats() == ts.stats()
    assert any(e[0] == "stuck" for e in ts.events)


def _conv_case(seed=0, B=2, img=8, C=3, M=16):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, img, img, C)).astype(np.float32)
    w = rng.uniform(-1, 1, (3, 3, C, M)).astype(np.float32)
    r_x = rq.choose_qparams(jnp.float32(x.min()), jnp.float32(x.max()))
    r_w = rq.choose_qparams(jnp.float32(w.min()), jnp.float32(w.max()))
    t_x = tq.choose_qparams(float(x.min()), float(x.max()))
    t_w = tq.choose_qparams(float(w.min()), float(w.max()))
    return x, w, (r_x, r_w), (t_x, t_w)


def _profile(pkg, cls, rate=1.0, seed=5, geom=RGEOM, layer="nc_conv2d"):
    """One covered class on this geometry; the stuck profile targets the
    slice pass 0 maps to (the reference suite's ``_profile_for``)."""
    if cls == "stuck":
        probe = pkg.FaultState(pkg.FaultProfile(n_slices=geom.n_slices))
        sid = probe.slice_for(layer, 0)
        return pkg.FaultProfile(seed=seed, stuck_slices=(sid,),
                                n_slices=geom.n_slices)
    kw = {"filter_flip": "filter_flip_rate", "act_flip": "act_flip_rate",
          "compute": "compute_rate"}[cls]
    return pkg.FaultProfile(seed=seed, n_slices=geom.n_slices, **{kw: rate})


def _both(case, cls=None, rate=1.0, seed=5, padding="SAME", engine="gemm",
          **kw):
    """Run the checked conv in both packages (the reference on ``host``,
    the port on ``engine``), each under its own fault scope; returns
    ``((out, cycles, stats, fault_state), ...)``."""
    x, w, (r_x, r_w), (t_x, t_w) = case
    B = x.shape[0]
    res = []
    for pkg, nc, geom, xin, win, xq, wq, eng in (
            (rfaults, rnc, RGEOM, x, w, [r_x] * B, r_w, "host"),
            (tfaults, tnc, TGEOM, torch.from_numpy(x), torch.from_numpy(w),
             [t_x] * B, t_w, engine)):
        prof = _profile(pkg, cls, rate, seed, geom)
        with pkg.inject(prof) as fs:
            out = nc.nc_conv2d(xin, win, xq, wq, 1, padding=padding,
                               geom=geom, engine=eng, return_stats=True,
                               **kw)
        res.append(out + (fs,))
    return res


def _same(ref, port):
    (ro, rc, rst, rfs), (to, tc, tst, tfs) = ref, port
    np.testing.assert_array_equal(np.asarray(ro), to.numpy())
    assert rc == tc
    rd, td = dataclasses.asdict(rst), dataclasses.asdict(tst)
    for key in UNCOUNTED:
        rd.pop(key), td.pop(key)
    assert rd == td
    assert dataclasses.asdict(rst.plan) == dataclasses.asdict(tst.plan)
    assert rfs.stats() == tfs.stats()
    assert rfs.events == tfs.events


@pytest.mark.parametrize("engine", ["gemm", "walk"])
@pytest.mark.parametrize("cls", tfaults.COVERED_CLASSES)
def test_checked_conv_under_each_class(cls, engine):
    case = _conv_case()
    ref, port = _both(case, cls, integrity=True, engine=engine)
    _same(ref, port)
    fs, st = port[3], port[2]
    assert fs.corrupt_attempts > 0
    assert fs.detected == fs.corrupt_attempts  # zero silent corruption
    assert fs.reexecuted == st.reexec_passes > 0
    clean, cyc, _ = tnc.nc_conv2d(torch.from_numpy(case[0]),
                                  torch.from_numpy(case[1]),
                                  [case[3][0]] * 2, case[3][1], 1,
                                  padding="SAME", return_stats=True)
    assert torch.equal(clean, port[0])
    assert port[1] == cyc + st.integrity_cycles + st.reexec_cycles


@pytest.mark.parametrize("shape", [dict(), dict(seed=3, img=9, C=1, M=6)])
@pytest.mark.parametrize("cls", tfaults.COVERED_CLASSES)
def test_walk_counts_every_execution_under_faults(cls, shape):
    """``walk`` under a fault scope counts its elision as ``host``:
    ``engine_words_*`` and the whole ``SKIP_STATS`` snapshot equal.  A pass
    whose operands a fault corrupts runs alone and counts that execution
    and every re-execution; the others count the clean one call once (K =
    9: rows share words, ragged tiles)."""
    tbs.SKIP_STATS.reset()
    kw = dict(tile_pixels=7, tile_filters=4) if shape else {}
    ref, port = _both(_conv_case(**shape), cls, 0.3 if shape else 1.0,
                      integrity=True, engine="walk", **kw)
    _same(ref, port)
    for key in UNCOUNTED[:2]:
        assert getattr(ref[2], key) == getattr(port[2], key)
    assert port[2].engine_words_total > 0
    assert tbs.SKIP_STATS.snapshot() == rbs.SKIP_STATS.snapshot()
    assert port[3].reexecuted > 0
    tbs.SKIP_STATS.reset()


@pytest.mark.parametrize("cls,rate", [("filter_flip", 0.3), ("act_flip", 0.3),
                                      ("compute", 0.3), ("stuck", 1.0)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_checked_conv_many_passes_and_shared_words(cls, rate, padding):
    """Many passes (ragged tile overrides), rows sharing words (K = 9): the
    bulk verification and the per-pass re-runs give the reference's
    serial-loop counters."""
    case = _conv_case(seed=3, B=2, img=9, C=1, M=6)
    ref, port = _both(case, cls, rate, seed=11, padding=padding,
                      integrity=True, tile_pixels=7, tile_filters=4)
    _same(ref, port)
    assert port[2].tiles > 4 and port[3].detected == port[3].corrupt_attempts


def test_stuck_slice_quarantined_and_replanned():
    case = _conv_case()
    ref, port = _both(case, "stuck", integrity=True)
    _same(ref, port)
    _, _, st, fs = port
    sid = fs.profile.stuck_slices[0]
    assert sid in fs.quarantined and sid in st.quarantined_slices
    assert sid in st.plan.quarantined_slices
    assert fs.detected == fs.corrupt_attempts > fs.profile.max_retries


def test_faults_without_integrity_flow_through():
    case = _conv_case()
    ref, port = _both(case, "compute")
    _same(ref, port)
    assert port[3].corrupt_attempts > 0 and port[3].detected == 0
    assert port[2].verify_passes == 0


def test_clean_integrity_and_compressed_overlap():
    """Integrity without faults verifies every pass; a compressed overlap
    plan reports the per-pass CSR stores' bytes."""
    case = _conv_case(seed=4, B=2, img=12, C=32, M=64)
    x, w, (r_x, r_w), (t_x, t_w) = case
    spec = dict(name="c", kind="conv", H=12, R=3, S=3, C=32, M=64, E=12,
                stride=1)
    r_plan = rnc.sched.plan_layer(rnc.LayerSpec(**spec), RGEOM.scaled(1),
                                  batch=2, overlap=True, compressed=True,
                                  integrity=True)
    t_plan = tsched.plan_layer(tsched.LayerSpec(**spec), TGEOM.scaled(1),
                               batch=2, overlap=True, compressed=True,
                               integrity=True)
    assert t_plan.overlap and t_plan.serial_passes > 1
    ref = rnc.nc_conv2d(x, w, [r_x] * 2, r_w, padding="SAME",
                        geom=RGEOM.scaled(1), plan=r_plan,
                        return_stats=True)
    got = tnc.nc_conv2d(torch.from_numpy(x), torch.from_numpy(w), [t_x] * 2,
                        t_w, padding="SAME", geom=TGEOM.scaled(1),
                        plan=t_plan, return_stats=True)
    np.testing.assert_array_equal(np.asarray(ref[0]), got[0].numpy())
    assert ref[1] == got[1]
    rd, td = dataclasses.asdict(ref[2]), dataclasses.asdict(got[2])
    for key in UNCOUNTED:
        rd.pop(key), td.pop(key)
    assert rd == td and td["verify_passes"] == td["tiles"] > 1
    assert td["csr_payload_bytes"] > 0 and td["csr_index_bytes"] > 0


def test_unrecoverable_corruption_raises_integrity_error():
    """A fault that persists across retries and quarantine raises; on a
    one-slice geometry there is no slice left to quarantine."""
    case = _conv_case(img=6, M=8)
    x, w, _, (t_x, t_w) = case
    prof = tfaults.FaultProfile(seed=0, n_slices=1)
    with tfaults.inject(prof) as fs:
        def always_corrupt(vals, layer, pass_index, *, filters, rows):
            out = vals.to(torch.int64).clone()
            out[0, 0] += 1
            return out

        fs.corrupt_values = always_corrupt
        with pytest.raises(tfaults.IntegrityError) as ei:
            tnc.nc_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          [t_x] * 2, t_w, padding="SAME",
                          geom=TGEOM.scaled(1), integrity=True)
    assert ei.value.layer == "nc_conv2d"
    assert ei.value.attempts == prof.max_retries + 1
    assert fs.detected == prof.max_retries + 1
    assert fs.reexecuted == prof.max_retries
