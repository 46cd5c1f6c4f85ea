"""The port's packed bit-serial engine against the JAX reference.

Integer results must match exactly: packed words (as uint32, word for word),
dot values, reductions, min/max and every cycle count.
"""
import numpy as np
import pytest
import torch

from repro.core import bitserial as rbs
from repro_torch.core import backends as tbk
from repro_torch.core import bitserial as tbs

torch.set_num_threads(1)

KS = [1, 3, 16, 17, 32, 33, 288]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("row_align", [False, True])
@pytest.mark.parametrize("n_bits", [1, 8, 32])
def test_pack_values_words_equal(K, row_align, n_bits):
    rng = np.random.default_rng(K * 7 + n_bits)
    x = rng.integers(0, 1 << n_bits, size=(5, K), dtype=np.uint64)
    ref = rbs.pack_values(x, n_bits, row_align=row_align)
    got = tbs.pack_values(_t(x), n_bits, row_align=row_align)
    assert got.words.dtype == torch.int64
    assert (np.asarray(ref.words, np.uint32).astype(np.int64)
            == got.words.numpy()).all()
    assert (got.lane_shape, got.row_lanes) == (ref.lane_shape, ref.row_lanes)
    assert (tbs.unpack_values(got).numpy() == x.astype(np.int64)).all()


@pytest.mark.parametrize("K", KS)
def test_lanes_roundtrip_and_shuffle(K):
    rng = np.random.default_rng(K)
    planes = rng.integers(0, 2, size=(3, 4, K), dtype=np.uint8)
    for ra in (False, True):
        ref = rbs.pack_lanes(planes, row_align=ra)
        got = tbs.pack_lanes(torch.from_numpy(planes), row_align=ra)
        assert (np.asarray(ref.words).astype(np.int64) == got.words.numpy()).all()
        assert (tbs.unpack_lanes(got).numpy() == planes).all()
    flat = tbs.pack_lanes(torch.from_numpy(planes))
    rows = tbs.shuffle_to_rows(flat)
    assert (np.asarray(rbs.shuffle_to_rows(rbs.pack_lanes(planes)).words)
            .astype(np.int64) == rows.words.numpy()).all()


def _grids(K, rows, filters, nx, nw, rng):
    """Row-aligned reference word grids shaped as nc_layers broadcasts them."""
    P, wpr, r = rbs._row_layout(K)
    x = rng.integers(0, 1 << nx, size=(rows, K))
    w = rng.integers(0, 1 << nw, size=(filters, K))
    xw = np.asarray(rbs.pack_values(x, nx, row_align=True).words)
    if r == 1:
        xw = xw.reshape(nx, 1, rows, wpr)
        ww = np.asarray(rbs.pack_values(w, nw, row_align=True).words)
        ww = ww.reshape(nw, filters, 1, wpr)
    else:
        xw = xw.reshape(nx, 1, -1)
        rep = sum(1 << (j * P) for j in range(r))
        ks = np.arange(K, dtype=np.uint64)
        wu = w.astype(np.uint64)
        ww = np.stack([((((wu >> np.uint64(p)) & 1) << ks).sum(axis=1) * rep)
                       for p in range(nw)]).astype(np.uint32)[:, :, None]
    return xw, ww


@pytest.mark.parametrize("K", [3, 16, 17, 33, 288])
@pytest.mark.parametrize("nx,nw", [(8, 8), (4, 4), (1, 2), (8, 3)])
@pytest.mark.parametrize("engine", ["walk", "gemm"])
def test_packed_dot_words_equal_host(K, nx, nw, engine):
    rng = np.random.default_rng(K + 10 * nx + nw)
    xw, ww = _grids(K, 7, 5, nx, nw, rng)
    ref, c_ref = rbs.packed_dot_words(xw, ww, K=K, acc_bits=32, engine="host")
    tbk.dispatch_stats_clear()
    got, c_got = tbs.packed_dot_words(_t(xw), _t(ww), K=K, acc_bits=32,
                                      engine=engine)
    assert c_got == c_ref
    assert tuple(got.shape) == np.asarray(ref).shape
    assert (np.asarray(ref) == got.numpy()).all()
    assert tbk.dispatch_stats()[engine] == {"native": 1, "fallback": 0}


def test_gemm_delegates_outside_envelope():
    """Narrow accumulators and >8 planes run the walk, counted."""
    rng = np.random.default_rng(5)
    for nx, nw, acc in [(8, 8, 12), (9, 2, 32)]:
        xw, ww = _grids(40, 3, 2, nx, nw, rng)
        ref, _ = rbs.packed_dot_words(xw, ww, K=40, acc_bits=acc, engine="host")
        tbk.dispatch_stats_clear()
        got, _ = tbs.packed_dot_words(_t(xw), _t(ww), K=40, acc_bits=acc,
                                      engine="gemm")
        assert (np.asarray(ref) == got.numpy()).all()
        assert tbk.dispatch_stats()["gemm"] == {"native": 0, "fallback": 1}


def test_backend_precedence_and_env(monkeypatch):
    assert tbk.resolve_backend() == "gemm"
    monkeypatch.setenv("NC_TORCH_BACKEND", "walk")
    assert tbk.resolve_backend() == "walk"
    assert tbk.resolve_backend(plan_backend="gemm") == "gemm"
    assert tbk.resolve_backend("gemm", "walk") == "gemm"
    monkeypatch.setenv("NC_BACKEND", "host")  # the reference's variable
    assert tbk.resolve_backend() == "walk"
    monkeypatch.setenv("NC_TORCH_BACKEND", "nope")
    with pytest.raises(ValueError, match="gemm, walk"):
        tbk.resolve_backend()


def test_resolve_backend_default_precedence(monkeypatch):
    """explicit > plan > ``NC_TORCH_BACKEND`` > ``default`` > ``gemm``, the
    reference's order (whose last word is ``host``)."""
    monkeypatch.delenv("NC_TORCH_BACKEND", raising=False)
    assert tbk.resolve_backend(default="walk") == "walk"
    assert tbk.resolve_backend(default=None) == "gemm"
    assert tbk.resolve_backend(plan_backend="gemm", default="walk") == "gemm"
    assert tbk.resolve_backend("gemm", "walk", default="walk") == "gemm"
    with pytest.raises(ValueError, match="gemm, walk"):
        tbk.resolve_backend(default="host")
    monkeypatch.setenv("NC_TORCH_BACKEND", "gemm")
    assert tbk.resolve_backend(default="walk") == "gemm"
    assert tbk.resolve_backend(plan_backend="walk", default="gemm") == "walk"


@pytest.mark.parametrize("row_align", [False, True])
@pytest.mark.parametrize("shape", [(5, 37), (3, 4, 9), (70,)])
def test_packed_planes_words_and_rows(row_align, shape):
    """``n_words`` and ``n_rows`` as the reference's; ``n_rows`` raises the
    reference's error on flat-packed planes."""
    x = np.random.default_rng(len(shape)).integers(0, 256, size=shape,
                                                   dtype=np.uint64)
    ref = rbs.pack_values(x, 8, row_align=row_align)
    got = tbs.pack_values(_t(x), 8, row_align=row_align)
    assert got.n_words == ref.n_words
    if row_align:
        assert got.n_rows == ref.n_rows == int(np.prod(shape[:-1]))
        return
    for pp in (ref, got):
        with pytest.raises(ValueError,
                           match="flat-packed planes have no row structure"):
            pp.n_rows


@pytest.mark.parametrize("k", [1, 2, 5, 9, 32, 33, 100])
@pytest.mark.parametrize("width", [8, 32])
def test_reduce_and_minmax_equal(k, width):
    rng = np.random.default_rng(k + width)
    x = rng.integers(0, 1 << width, size=(3, k), dtype=np.uint64)
    ref = rbs.pack_values(x, width, row_align=True)
    got = tbs.pack_values(_t(x), width, row_align=True)
    r_red, c_r = rbs.bitserial_reduce(ref)
    t_red, c_t = tbs.bitserial_reduce(got)
    assert c_r == c_t == tbs.reduce_cycles(k, width)
    assert (np.asarray(rbs.unpack_values(r_red)) == tbs.unpack_values(t_red).numpy()).all()
    (r_mn, r_mx), c_r = rbs.bitserial_minmax(ref)
    (t_mn, t_mx), c_t = tbs.bitserial_minmax(got)
    assert c_r == c_t == tbs.minmax_cycles(k, width)
    assert (np.asarray(rbs.unpack_values(r_mn)) == tbs.unpack_values(t_mn).numpy()).all()
    assert (np.asarray(rbs.unpack_values(r_mx)) == tbs.unpack_values(t_mx).numpy()).all()


def test_max_and_selective_copy_equal():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, size=(4, 37))
    b = rng.integers(0, 256, size=(4, 37))
    mask = rng.integers(0, 2, size=(4, 37))
    ra, rb_ = rbs.pack_values(a, 8), rbs.pack_values(b, 8)
    ta, tb = tbs.pack_values(_t(a), 8), tbs.pack_values(_t(b), 8)
    r_out, c_r = rbs.bitserial_max(ra, rb_)
    t_out, c_t = tbs.bitserial_max(ta, tb)
    assert c_r == c_t
    assert (tbs.unpack_values(t_out).numpy() == np.maximum(a, b)).all()
    assert (np.asarray(r_out.words).astype(np.int64) == t_out.words.numpy()).all()
    r_sel, c_r = rbs.selective_copy(ra, rb_, mask)
    t_sel, c_t = tbs.selective_copy(ta, tb, torch.from_numpy(mask))
    assert c_r == c_t
    assert (tbs.unpack_values(t_sel).numpy() == np.where(mask, b, a)).all()
    # raw {0,1} planes in, raw planes out, like the reference
    pa = rbs.bitplane_pack(a, 8)
    pb = rbs.bitplane_pack(b, 8)
    r_raw, _ = rbs.bitserial_max(pa, pb)
    t_raw, _ = tbs.bitserial_max(torch.from_numpy(pa), torch.from_numpy(pb))
    assert (np.asarray(r_raw) == t_raw.numpy()).all()


def test_cycle_formulas_and_occupancy():
    for n in range(1, 33):
        assert tbs.add_cycles(n) == rbs.add_cycles(n)
        assert tbs.mul_cycles(n) == rbs.mul_cycles(n)
        assert tbs.div_cycles(n) == rbs.div_cycles(n)
        for k in (1, 2, 3, 64, 1000):
            assert tbs.reduce_cycles(k, n) == rbs.reduce_cycles(k, n)
            assert tbs.minmax_cycles(k, n) == rbs.minmax_cycles(k, n)
            assert tbs.dot_cycles(k, n, 32) == rbs.dot_cycles(k, n, 32)
    card_r, card_t = rbs.OpCycles(), tbs.OpCycles()
    assert (card_r.mac_floor, card_r.mac_overhead) == (card_t.mac_floor,
                                                      card_t.mac_overhead)
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 16, size=(6, 10))
    rows[[1, 4]] = 3
    rz, rp = rbs.filter_occupancy(rows, 8, zero=3)
    tz, tp = tbs.filter_occupancy(torch.from_numpy(rows), 8, zero=3)
    assert (rz == tz.numpy()).all() and (rp == tp.numpy()).all()


def _filter_rows(kind: str, M: int, K: int, seed: int) -> np.ndarray:
    """uint8 filter rows ``[M, K]``: every plane live (``dense``), the last
    half of the filters zero (``pruned50``), or no value above 127 so the
    top plane is dead (``dead_plane``)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256 if kind != "dead_plane" else 128, (M, K))
    if kind == "pruned50":
        rows[M // 2:] = 0
    return rows.astype(np.int64)


@pytest.mark.parametrize("K", [9, 75])  # P = 16 (< 32) and P = 128 (>= 32)
@pytest.mark.parametrize("kind", ["dense", "pruned50", "dead_plane"])
def test_compressed_planes_against_the_reference(kind, K):
    """The CSR filter store of both packages over the filter word grid
    ``nc_conv2d`` builds: bytes, ``dense()`` and ``dense_columns`` on
    ragged ranges; and ``split_bytes`` over one slice equal to the store's
    bytes (the count a serial compressed plan reports), over ragged slices
    equal to the sum of the reference's per-slice stores (an overlap
    plan's)."""
    from repro.core import nc_layers as rnc
    from repro_torch.core import nc_layers as tnc

    M = 13
    rows = _filter_rows(kind, M, K, seed=K)
    ref_grid = rnc._pack_w_rows(rows.astype(np.uint64), 8)
    grid = tnc._pack_w_rows(_t(rows), 8)
    assert (np.asarray(ref_grid).astype(np.int64) == grid.numpy()).all()
    ref = rbs.CompressedPlanes.compress(ref_grid)
    got = tbs.CompressedPlanes.compress(grid)
    assert (got.payload_bytes, got.index_bytes, got.live_planes) == (
        ref.payload_bytes, ref.index_bytes, ref.live_planes)
    assert got.live_planes == (7 if kind == "dead_plane" else 8)
    assert torch.equal(got.dense(), grid)
    for m0, m1 in ((0, M), (0, 1), (2, 9), (6, 7), (M - 1, M), (5, 5)):
        assert torch.equal(got.dense_columns(m0, m1), grid[:, m0:m1])
        assert (np.asarray(ref.dense_columns(m0, m1)).astype(np.int64)
                == got.dense_columns(m0, m1).numpy()).all()
    assert tbs.CompressedPlanes.split_bytes(grid, [(0, M)]) == (
        got.payload_bytes, got.index_bytes)
    tiles = [(0, 4), (4, 8), (8, 12), (12, M)]
    per = [rbs.CompressedPlanes.compress(ref_grid[:, m0:m1])
           for m0, m1 in tiles]
    assert tbs.CompressedPlanes.split_bytes(grid, tiles) == (
        sum(c.payload_bytes for c in per), sum(c.index_bytes for c in per))
