"""The port's backends against the reference's ``host`` body: the whole
conformance envelope of ``tests/test_backends.py`` (``CONV_CASES``: 8/4/2/1
bits, W4A4, SAME/VALID, stride 2, batch 1 and 4, ragged tiles, CSR and
dense stores, integrity on and off, 0/50/100% pruning) through ``walk`` and
``gemm``, the FC path and raw ``packed_dot_words``.

Tolerance: none.  Values, modeled cycles and every ``ConvStats`` field
must be equal, and the executed plan equal field for field.  ``walk``
elides zero-operand words and dead planes as ``host`` does, so its
``engine_words_*`` and the whole ``SKIP_STATS`` snapshot must equal
``host``'s too, with integrity on and off and on activations that are 97%
zeros.  ``gemm`` is held to every field but ``engine_words_*``: its native
path elides nothing and leaves them 0, where the reference's compiled
engines count only the calls they delegate to ``host`` (``K <= 16``
among them, which ``gemm`` decodes natively).  ``gemm`` runs the kernels'
plain versions on the CPU; a dot whose operands both fit 4 planes must
take the W4A4 route.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import bitserial as rbs
from repro.core import nc_layers as rnc
from repro.core import quantize as rq
from repro.core.cache_geometry import XEON_E5_35MB as RGEOM
from repro_torch.core import backends as tbackends
from repro_torch.core import bitserial as tbs
from repro_torch.core import nc_layers as tnc
from repro_torch.core import quantize as tq
from repro_torch.core.cache_geometry import XEON_E5_35MB as TGEOM
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

PORT_BACKENDS = ["walk", "gemm"]
# fields each backend is not held to (the plan is compared on its own)
UNCOUNTED = {"walk": ("plan",),
             "gemm": ("engine_words_total", "engine_words_skipped", "plan")}


@pytest.fixture(autouse=True)
def _port_engine_state():
    """The port's ``SKIP_STATS`` and ``ZERO_SKIP`` are process-wide; the
    reference's are reset by tests/conftest.py."""
    tbs.SKIP_STATS.reset()
    zero_skip = tbs.ZERO_SKIP
    yield
    tbs.ZERO_SKIP = zero_skip
    tbs.SKIP_STATS.reset()


def _case(seed, *, bits=8, M=6, C=3, R=3, prune=0.0, batch=1, img=8):
    """The reference suite's ``_quantized_conv_case``, with the
    QuantParams of both packages."""
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    zw = hi // 2
    wq = rng.integers(0, hi, size=(R, R, C, M)).astype(np.uint8)
    k = int(round(M * prune))
    if k:
        idx = rng.choice(M, size=k, replace=False)
        wq[..., idx] = zw
    shape = (batch, img, img, C) if batch > 1 else (img, img, C)
    xq = rng.integers(0, hi, size=shape).astype(np.uint8)
    r_x = rq.QuantParams(scale=np.float32(1 / hi), zero_point=1, bits=bits)
    r_w = rq.QuantParams(scale=np.float32(0.05), zero_point=zw, bits=bits)
    t_x = tq.QuantParams(scale=float(np.float32(1 / hi)), zero_point=1,
                         bits=bits)
    t_w = tq.QuantParams(scale=float(np.float32(0.05)), zero_point=zw,
                         bits=bits)
    if batch > 1:
        r_x, t_x = [r_x] * batch, [t_x] * batch
    return xq, wq, (r_x, r_w), (t_x, t_w)


CONV_CASES = [
    pytest.param(dict(bits=8), id="w8a8-valid-dense"),
    pytest.param(dict(bits=8, padding="SAME", stride=2, batch=4,
                      tile_pixels=7, prune=0.5), id="w8a8-same-s2-b4-ragged-p50"),
    pytest.param(dict(bits=8, batch=4, compressed=True, integrity=True,
                      tile_filters=5, prune=0.5), id="w8a8-b4-csr-abft-p50"),
    pytest.param(dict(bits=4), id="w4a4-valid-dense"),
    pytest.param(dict(bits=4, padding="SAME", stride=2, batch=4,
                      compressed=True, prune=0.5), id="w4a4-same-s2-b4-csr-p50"),
    pytest.param(dict(bits=2, integrity=True), id="w2a2-abft"),
    pytest.param(dict(bits=1, padding="SAME", batch=4, prune=0.5),
                 id="w1a1-same-b4-p50"),
    pytest.param(dict(bits=8, batch=4, prune=1.0), id="w8a8-b4-p100"),
]


def _stats(stats, backend):
    d = dataclasses.asdict(stats)
    for key in UNCOUNTED[backend]:
        d.pop(key)
    return d


def _run(case, engine, sparse_x=False):
    kw = dict(case)
    xq, wq, (r_x, r_w), (t_x, t_w) = _case(
        0xC0FFEE, bits=kw.pop("bits"), prune=kw.pop("prune", 0.0),
        batch=kw.setdefault("batch", 1))
    if sparse_x:
        xq[np.random.default_rng(5).random(xq.shape) < 0.97] = 0
    kw.pop("batch")
    stride = kw.pop("stride", 1)
    if engine == "host":
        out, cycles, st = rnc.nc_conv2d(
            xq, wq, r_x, r_w, stride, geom=RGEOM, occupancy="detect",
            engine="host", return_stats=True, **kw)
        return np.asarray(out), cycles, st
    out, cycles, st = tnc.nc_conv2d(
        torch.from_numpy(xq), torch.from_numpy(wq), t_x, t_w, stride,
        geom=TGEOM, occupancy="detect", engine=engine, return_stats=True,
        **kw)
    assert out.dtype == torch.int32
    return out.numpy(), cycles, st


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_conformance(case, backend):
    ref, ref_cycles, ref_st = _run(case, "host")
    tbackends.dispatch_stats_clear()
    out, cycles, st = _run(case, backend)
    np.testing.assert_array_equal(out, ref)
    assert cycles == ref_cycles
    assert _stats(st, backend) == _stats(ref_st, backend)
    assert dataclasses.asdict(st.plan) == dataclasses.asdict(ref_st.plan)
    d = tbackends.dispatch_stats()[backend]
    if case.get("prune") != 1.0:  # fully pruned layers run zero passes
        assert d["native"] > 0 and d["fallback"] == 0
    if backend == "gemm":
        assert (st.engine_words_total, st.engine_words_skipped) == (0, 0)


@pytest.mark.parametrize("sparse_x", [False, True])
@pytest.mark.parametrize("integrity", [False, True])
@pytest.mark.parametrize("case", CONV_CASES)
def test_walk_counts_equal_host(case, integrity, sparse_x):
    """``walk`` counts its zero-operand elision per plan tile as ``host``
    does: ``engine_words_*`` and every ``SKIP_STATS`` field equal, over
    the envelope with integrity on and off, on dense activations and on
    activations that are 97% zeros (whole words elided)."""
    case = dict(case, integrity=integrity)
    ref, ref_cycles, ref_st = _run(case, "host", sparse_x)
    out, cycles, st = _run(case, "walk", sparse_x)
    np.testing.assert_array_equal(out, ref)
    assert cycles == ref_cycles
    assert _stats(st, "walk") == _stats(ref_st, "walk")
    assert tbs.SKIP_STATS.snapshot() == rbs.SKIP_STATS.snapshot()
    if case.get("prune") != 1.0:
        assert st.engine_words_total > 0
        if sparse_x:
            assert st.engine_words_skipped > 0


@pytest.mark.parametrize("tile_pixels", [None, 5])
def test_walk_counts_dead_planes_of_gathered_columns(tile_pixels):
    """A tile whose live word columns are gathered skips the multiplier
    planes that none of those columns carries, though its filter words
    carry them: K = 64 (two words a row), the second word's activations all
    zero and its weights only in plane 7."""
    rng = np.random.default_rng(12)
    xq = rng.integers(0, 256, size=(2, 6, 6, 64)).astype(np.uint8)
    xq[..., 32:] = 0
    wq = (rng.integers(0, 128, size=(1, 1, 64, 6))).astype(np.uint8)
    wq[:, :, 32:] = 0x80
    r_qp = rq.QuantParams(scale=np.float32(0.05), zero_point=0)
    t_qp = tq.QuantParams(scale=float(np.float32(0.05)), zero_point=0)
    kw = dict(tile_pixels=tile_pixels, return_stats=True)
    ref, _, r_st = rnc.nc_conv2d(xq, wq, [r_qp] * 2, r_qp, geom=RGEOM,
                                 engine="host", **kw)
    out, _, t_st = tnc.nc_conv2d(torch.from_numpy(xq), torch.from_numpy(wq),
                                 [t_qp] * 2, t_qp, geom=TGEOM, engine="walk",
                                 **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert _stats(t_st, "walk") == _stats(r_st, "walk")
    snap = tbs.SKIP_STATS.snapshot()
    assert snap == rbs.SKIP_STATS.snapshot()
    assert snap["words_skipped"] * 2 == snap["words_total"]
    assert snap["planes_skipped"] == snap["planes_total"] // 8  # plane 7


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("batch", [1, 4])
def test_fc_conformance(backend, batch):
    rng = np.random.default_rng(7)
    K, M = 144, 10
    x = rng.integers(0, 256, size=(batch, K) if batch > 1 else (K,))
    w = rng.integers(0, 256, size=(K, M)).astype(np.uint8)
    w[:, ::3] = 11  # a third of the filters prune to the zero point
    r_x = rq.QuantParams(scale=np.float32(1 / 256), zero_point=0)
    r_w = rq.QuantParams(scale=np.float32(0.02), zero_point=11)
    t_x = tq.QuantParams(scale=float(np.float32(1 / 256)), zero_point=0)
    t_w = tq.QuantParams(scale=float(np.float32(0.02)), zero_point=11)
    if batch > 1:
        r_x, t_x = [r_x] * batch, [t_x] * batch
    ref, ref_cycles, ref_st = rnc.nc_fc(x.astype(np.uint8), w, r_x, r_w,
                                        occupancy="detect", engine="host",
                                        return_stats=True)
    out, cycles, st = tnc.nc_fc(torch.from_numpy(x.astype(np.uint8)),
                                torch.from_numpy(w), t_x, t_w,
                                occupancy="detect", engine=backend,
                                return_stats=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert cycles == ref_cycles
    assert _stats(st, backend) == _stats(ref_st, backend)


def _grids(bits_x, bits_w, K, seed, T=13, M=5):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << bits_x, size=(T, K))
    w = rng.integers(0, 1 << bits_w, size=(M, K))
    r = (rnc._pack_x_rows(x.astype(np.uint32), bits_x),
         rnc._pack_w_rows(w.astype(np.uint32), bits_w))
    t = (tnc._pack_x_rows(torch.from_numpy(x), bits_x),
         tnc._pack_w_rows(torch.from_numpy(w), bits_w))
    return r, t


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("bits_x,bits_w", [(8, 8), (4, 4), (2, 4), (1, 8)])
@pytest.mark.parametrize("K", [144, 37, 9])
def test_dot_words_conformance(backend, bits_x, bits_w, K):
    """Packed word grids through ``packed_dot_words``: the port's words
    equal the reference's, and values and cycles equal the host body's
    (K=9 puts rows sharing words)."""
    (rx, rw), (tx, tw) = _grids(bits_x, bits_w, K,
                                K * 100 + bits_x * 10 + bits_w)
    assert (tx.numpy() == rx.astype(np.int64)).all()
    assert (tw.numpy() == rw.astype(np.int64)).all()
    ref, ref_cycles = rbs.packed_dot_words(rx, rw, K=K, acc_bits=32,
                                           engine="host")
    vals, cycles = tbs.packed_dot_words(tx, tw, K=K, acc_bits=32,
                                        engine=backend)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref))
    assert cycles == ref_cycles


@pytest.mark.parametrize("bits_x,bits_w", [(4, 4), (3, 2), (1, 1), (8, 4),
                                           (4, 8)])
@pytest.mark.parametrize("K", [2, 5, 16, 37, 144])
def test_gemm_routes_four_plane_dots_to_a4(monkeypatch, bits_x, bits_w, K):
    """A dot whose operands both fit 4 planes (and K >= 2) reaches the W4A4
    kernel's entry with nibble-packed activations, rows sharing words
    (K <= 16) included; wider dots take the 8-bit kernel.  Values equal the
    walk's either way."""
    calls = []
    real = tops.bitserial_matmul_exact

    def spy(x_q, planes, *, n_bits, w4a4=False):
        calls.append((w4a4, tuple(x_q.shape), tuple(planes.shape)))
        return real(x_q, planes, n_bits=n_bits, w4a4=w4a4)

    monkeypatch.setattr(tops, "bitserial_matmul_exact", spy)
    _, (tx, tw) = _grids(bits_x, bits_w, K, K + bits_x + bits_w)
    want, _ = tbs.packed_dot_words(tx, tw, K=K, acc_bits=32, engine="walk")
    got, _ = tbs.packed_dot_words(tx, tw, K=K, acc_bits=32, engine="gemm")
    assert torch.equal(got, want)
    a4 = bits_x <= 4 and bits_w <= 4
    assert len(calls) == 1
    w4a4, x_shape, p_shape = calls[0]
    assert w4a4 == a4
    assert p_shape[0] == K
    assert x_shape[1] == ((K + 1) // 2 if a4 else K)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("K", [144, 9])
def test_bare_packed_dot_words_runs_the_reference_default(monkeypatch, K,
                                                          sparse):
    """A call without ``engine=`` runs the exact walk, as the reference's
    runs its host walk, and neither package reads its environment variable
    for it: values, cycles and the ``SKIP_STATS`` snapshot equal the
    reference's, on dense rows and on rows mostly zero."""
    monkeypatch.setenv("NC_TORCH_BACKEND", "gemm")
    monkeypatch.setenv("NC_BACKEND", "jit")
    rng = np.random.default_rng(K + sparse)
    x = rng.integers(0, 256, size=(40, K))
    if sparse:
        x[rng.random(40) < 0.9] = 0
    w = rng.integers(0, 256, size=(5, K))
    rx, rw = (rnc._pack_x_rows(x.astype(np.uint32), 8),
              rnc._pack_w_rows(w.astype(np.uint32), 8))
    tx, tw = (tnc._pack_x_rows(torch.from_numpy(x), 8),
              tnc._pack_w_rows(torch.from_numpy(w), 8))
    rbs.SKIP_STATS.reset()
    tbackends.dispatch_stats_clear()
    ref, ref_cycles = rbs.packed_dot_words(rx, rw, K=K, acc_bits=32)
    vals, cycles = tbs.packed_dot_words(tx, tw, K=K, acc_bits=32)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref))
    assert cycles == ref_cycles
    snap = tbs.SKIP_STATS.snapshot()
    assert snap == rbs.SKIP_STATS.snapshot()
    assert snap["planes_total"] > 0
    stats = tbackends.dispatch_stats()
    assert stats["walk"] == {"native": 1, "fallback": 0}
    assert stats["gemm"] == {"native": 0, "fallback": 0}


def test_capability_envelope(monkeypatch):
    """The flags say what each body does natively: both take any
    accumulator, CSR-reconstructed tiles and the checked path; only
    ``gemm`` has a nibble route.  ``gemm`` reads ``supports_acc``: narrowed
    to 32-bit accumulators, a 24-bit one delegates to the walk, exactly."""
    walk, gemm = tbackends.get_backend("walk"), tbackends.get_backend("gemm")
    assert (walk.acc_bits, walk.w4a4, walk.compressed_planes,
            walk.integrity) == (None, False, True, True)
    assert (gemm.acc_bits, gemm.w4a4, gemm.compressed_planes,
            gemm.integrity) == (None, True, True, True)
    assert walk.supports_acc(24) and gemm.supports_acc(40)
    _, (tx, tw) = _grids(8, 8, 37, 3)
    want, _ = tbs.packed_dot_words(tx, tw, K=37, acc_bits=24, engine="walk")
    monkeypatch.setitem(tbackends._REGISTRY, "gemm",
                        dataclasses.replace(gemm, acc_bits=(32,)))
    for acc, native in ((24, 0), (32, 1)):
        tbackends.dispatch_stats_clear()
        got, _ = tbs.packed_dot_words(tx, tw, K=37, acc_bits=acc,
                                      engine="gemm")
        assert torch.equal(got, want)
        assert tbackends.dispatch_stats()["gemm"] == {
            "native": native, "fallback": 1 - native}


def test_gemm_reads_its_nibble_route_flag(monkeypatch):
    """``_exact_gemm`` routes 4-plane dots by the registered ``w4a4`` flag:
    with it cleared, the same dot reaches the 8-bit kernel's entry with
    byte activations, and its values still equal the walk's."""
    calls = []
    real = tops.bitserial_matmul_exact

    def spy(x_q, planes, *, n_bits, w4a4=False):
        calls.append((w4a4, tuple(x_q.shape)))
        return real(x_q, planes, n_bits=n_bits, w4a4=w4a4)

    monkeypatch.setattr(tops, "bitserial_matmul_exact", spy)
    monkeypatch.setitem(tbackends._REGISTRY, "gemm", dataclasses.replace(
        tbackends.get_backend("gemm"), w4a4=False))
    _, (tx, tw) = _grids(4, 4, 37, 5)
    want, _ = tbs.packed_dot_words(tx, tw, K=37, acc_bits=32, engine="walk")
    got, _ = tbs.packed_dot_words(tx, tw, K=37, acc_bits=32, engine="gemm")
    assert torch.equal(got, want)
    assert [(w4a4, shape[1]) for w4a4, shape in calls] == [(False, 37)]
