"""The port's §III arithmetic, its zero-operand elision and the layer
entry points built on them, against the JAX reference.

Every op (add, sub, multiply, MAC, ReLU, max, selective copy, dot) runs on
the same numpy-seeded inputs through ``repro.core.bitserial`` and
``repro_torch.core.bitserial``: flat and row-aligned, mixed widths, raw
plane tensors and ``PackedPlanes`` in, with one operand 90% zeros so that
both elisions fire, and ``ZERO_SKIP`` on and off.  The words must equal
the reference's as uint32, word for word; the values must equal integer
arithmetic on the inputs; the cycles the closed forms; and the
``SKIP_STATS`` snapshot the reference's.  Then ``nc_dot`` (``walk`` and
``gemm``), ``nc_relu_requant``, ``requantize_reference``, the reference's
per-plane pruning case through ``walk``, and the scaled kernel entry
points of ``kernels.ops``.

Tolerance: none, except ``quant_matmul_xla`` against the reference's
jitted one, where XLA's CPU backend fuses the epilogue's multiply and add
(bit-equal to the reference's un-jitted oracle instead, and within one ulp
of the jitted one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitserial as rbs
from repro.core import nc_layers as rnc
from repro.core import quantize as rq
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core import backends as tbk
from repro_torch.core import bitserial as tbs
from repro_torch.core import nc_layers as tnc
from repro_torch.core import quantize as tq
from repro_torch.kernels import bitserial_matmul as tbsm
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

KS = [1, 3, 16, 17, 32, 33, 288]


@pytest.fixture(autouse=True)
def _port_engine_state():
    """The port's ``SKIP_STATS`` and ``ZERO_SKIP`` are process-wide, as the
    reference's (which tests/conftest.py isolates): reset them here."""
    tbs.SKIP_STATS.reset()
    zero_skip = tbs.ZERO_SKIP
    yield
    tbs.ZERO_SKIP = zero_skip
    tbs.SKIP_STATS.reset()


def _zero_skip(on: bool) -> None:
    rbs.ZERO_SKIP = tbs.ZERO_SKIP = on
    rbs.SKIP_STATS.reset()
    tbs.SKIP_STATS.reset()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _words_equal(ref, got) -> bool:
    return bool((np.asarray(ref, np.uint32).astype(np.int64)
                 == got.numpy()).all())


def _operand(rng, bits, shape, sparse=False):
    """Seeded values; ``sparse`` zeroes the leading 90% of the lanes (C
    order), so whole words carry a zero operand."""
    x = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)
    if sparse:
        x.reshape(-1)[: x.size * 9 // 10] = 0
    return x


def _both(x, bits, form):
    """The same operand for both packages: raw planes, or PackedPlanes flat
    or row-aligned (the last axis the reduce axis)."""
    if form == "planes":
        p = rbs.bitplane_pack(x, bits)
        return p, torch.from_numpy(np.asarray(p))
    ra = form == "rows"
    return (rbs.pack_values(x, bits, row_align=ra),
            tbs.pack_values(_t(x), bits, row_align=ra))


def _same_result(ref, got):
    """Words (packed) or planes (raw) equal; returns the port's values."""
    if isinstance(got, tbs.PackedPlanes):
        assert (got.lane_shape, got.row_lanes) == (ref.lane_shape,
                                                    ref.row_lanes)
        assert _words_equal(ref.words, got.words)
        return tbs.unpack_values(got).numpy()
    assert (np.asarray(ref) == got.numpy()).all()
    return tbs.bitplane_unpack(got).numpy()


OPS = ["add", "sub", "multiply", "mac", "relu", "max", "selective_copy"]


def _expect(op, a, b, acc, wa, wb):
    a, b = a.astype(np.int64), b.astype(np.int64)
    n = max(wa, wb)
    if op == "add":
        return a + b, n + 1
    if op == "sub":
        return (a - b) & ((1 << (n + 1)) - 1), n + 1
    if op == "multiply":
        return a * b, n * n + 5 * n - 2
    if op == "mac":
        return (acc.astype(np.int64) + a * b) & ((1 << 24) - 1), \
            n * n + 5 * n - 2 + 24 + 1
    if op == "relu":
        signed = np.where(a >> (wa - 1), a - (1 << wa), a)
        return np.maximum(signed, 0), wa + 1
    if op == "max":
        return np.maximum(a, b), n + 1 + n + 1
    raise AssertionError(op)


@pytest.mark.parametrize("zero_skip", [True, False])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("form", ["flat", "rows", "planes"])
@pytest.mark.parametrize("op", OPS)
def test_op_equals_reference(op, form, sparse, zero_skip):
    rng = np.random.default_rng(OPS.index(op) * 7 + len(form) + sparse)
    shape = (6, 37)
    wa, wb = 8, 5  # mixed widths
    a = _operand(rng, wa, shape)
    b = _operand(rng, wb, shape, sparse)
    acc = _operand(rng, 24, shape)
    mask = rng.integers(0, 2, size=shape)
    ra, ta = _both(a, wa, form)
    rb_, tb = _both(b, wb, form)
    _zero_skip(zero_skip)
    if op == "mac":
        racc, tacc = _both(acc, 24, form)
        ref, rc = rbs.bitserial_mac(racc, ra, rb_)
        got, tc = tbs.bitserial_mac(tacc, ta, tb)
    elif op == "relu":
        ref, rc = rbs.bitserial_relu(ra)
        got, tc = tbs.bitserial_relu(ta)
    elif op == "selective_copy":
        ref, rc = rbs.selective_copy(ra, rb_, mask)
        got, tc = tbs.selective_copy(ta, tb, torch.from_numpy(mask))
    else:
        ref, rc = getattr(rbs, f"bitserial_{op}")(ra, rb_)
        got, tc = getattr(tbs, f"bitserial_{op}")(ta, tb)
    vals = _same_result(ref, got)
    assert tc == rc
    if op == "selective_copy":
        assert (vals == np.where(mask, b, a)).all() and tc == wa + 1
    else:
        want, cycles = _expect(op, a, b, acc, wa, wb)
        assert (vals == want).all()
        assert tc == cycles
    assert tbs.SKIP_STATS.snapshot() == rbs.SKIP_STATS.snapshot()
    if op in ("multiply", "mac") and zero_skip:
        snap = tbs.SKIP_STATS.snapshot()
        assert snap["words_total"] > 0 and snap["planes_total"] == wb
        if sparse:
            assert snap["words_skipped"] > 0 and snap["lanes_zero"] > 0


@pytest.mark.parametrize("form", ["flat", "rows"])
def test_zero_skip_off_gives_the_same_words(form):
    rng = np.random.default_rng(3)
    a = _operand(rng, 8, (9, 70))
    b = _operand(rng, 8, (9, 70), sparse=True)
    b[:, :] &= 0x7B  # two dead multiplier planes
    _, ta = _both(a, 8, form)
    _, tb = _both(b, 8, form)
    on, _ = tbs.bitserial_multiply(ta, tb)
    snap = tbs.SKIP_STATS.snapshot()
    assert snap["planes_skipped"] == 2
    tbs.ZERO_SKIP = False
    off, _ = tbs.bitserial_multiply(ta, tb)
    assert torch.equal(on.words, off.words)
    assert (tbs.unpack_values(on).numpy() == a.astype(np.int64) * b).all()


def test_reference_skip_case_200_lanes():
    """The reference's own case: 200 lanes make 7 words, of which only the
    first carries live pairs, so 6 are skipped."""
    rng = np.random.default_rng(24)
    a = rng.integers(0, 256, size=(200,), dtype=np.uint32)
    b = np.zeros((200,), np.uint32)
    b[:3] = rng.integers(1, 256, 3)
    rbs.SKIP_STATS.reset()
    rbs.bitserial_multiply(rbs.pack_values(a, 8), rbs.pack_values(b, 8))
    out, cyc = tbs.bitserial_multiply(tbs.pack_values(_t(a), 8),
                                      tbs.pack_values(_t(b), 8))
    assert (tbs.unpack_values(out).numpy() == a.astype(np.int64) * b).all()
    assert cyc == tbs.mul_cycles(8) == 102
    snap = tbs.SKIP_STATS.snapshot()
    assert snap == rbs.SKIP_STATS.snapshot()
    assert snap["words_total"] == 7 and snap["words_skipped"] == 6
    assert snap["lanes_zero"] >= 197


def test_quickstart_cycles():
    """The reference quickstart's first demo: an 8-bit add in 9 cycles and
    an 8-bit multiply in 102, bit-exact."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, 16)
    b = rng.integers(0, 256, 16)
    pa, pb = tbs.bitplane_pack(_t(a), 8), tbs.bitplane_pack(_t(b), 8)
    s, c_add = tbs.bitserial_add(pa, pb)
    p, c_mul = tbs.bitserial_multiply(pa, pb)
    assert (c_add, c_mul) == (9, 102)
    assert (tbs.bitplane_unpack(s).numpy() == a + b).all()
    assert (tbs.bitplane_unpack(p).numpy() == a * b).all()


@pytest.mark.parametrize("n_bits", [1, 5, 8, 16])
@pytest.mark.parametrize("signed", [False, True])
def test_bitplane_pack_unpack(n_bits, signed):
    rng = np.random.default_rng(n_bits)
    lo = -(1 << (n_bits - 1)) if signed else 0
    x = rng.integers(lo, lo + (1 << n_bits), size=(3, 11))
    ref = rbs.bitplane_pack((x & ((1 << n_bits) - 1)).astype(np.uint32),
                            n_bits)
    got = tbs.bitplane_pack(_t(x), n_bits)
    assert got.dtype == torch.uint8 and (np.asarray(ref) == got.numpy()).all()
    back = tbs.bitplane_unpack(got, signed=signed).numpy()
    assert (back == np.asarray(rbs.bitplane_unpack(ref, signed=signed))).all()
    assert (back == (x if signed else x & ((1 << n_bits) - 1))).all()
    pp = tbs.pack_values(_t(x & ((1 << n_bits) - 1)), n_bits)
    assert (tbs.bitplane_unpack(pp, signed=signed).numpy() == back).all()


@pytest.mark.parametrize("K", KS)
def test_shuffle_to_flat_round_trip(K):
    rng = np.random.default_rng(K)
    x = rng.integers(0, 256, size=(2, 5, K), dtype=np.uint64)
    flat_r, flat_t = rbs.pack_values(x, 8), tbs.pack_values(_t(x), 8)
    rows_t = tbs.shuffle_to_rows(flat_t)
    back_t = tbs.shuffle_to_flat(rows_t)
    back_r = rbs.shuffle_to_flat(rbs.shuffle_to_rows(flat_r))
    assert _words_equal(back_r.words, back_t.words)
    assert torch.equal(back_t.words, flat_t.words) and back_t.row_lanes == 0
    rows_direct = tbs.pack_values(_t(x), 8, row_align=True)
    assert _words_equal(rbs.shuffle_to_flat(
        rbs.pack_values(x, 8, row_align=True)).words,
        tbs.shuffle_to_flat(rows_direct).words)
    assert tbs.shuffle_to_flat(flat_t) is flat_t


def test_resize_planes():
    p = tbs.bitplane_pack(_t(np.arange(7)), 3)
    assert torch.equal(tbs._resize_planes(p, 3), p)
    assert torch.equal(tbs._resize_planes(p, 2), p[:2])
    wide = tbs._resize_planes(p, 6)
    assert wide.dtype == p.dtype and tuple(wide.shape) == (6, 7)
    assert torch.equal(tbs.bitplane_unpack(wide), tbs.bitplane_unpack(p))


@pytest.mark.parametrize("zero_skip", [True, False])
@pytest.mark.parametrize("shape", [(5,), (3, 9), (4, 2, 33), (2, 288)])
def test_bitserial_dot(shape, zero_skip):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = rng.integers(0, 256, size=shape)
    w = rng.integers(0, 256, size=shape)
    x[rng.random(shape) < 0.5] = 0
    _zero_skip(zero_skip)
    ref, rc = rbs.bitserial_dot(x, w)
    got, tc = tbs.bitserial_dot(_t(x), _t(w))
    assert tc == rc
    assert (got.numpy() == np.asarray(ref)).all()
    assert (got.numpy() == (x * w).sum(axis=-1)).all()
    assert tbs.SKIP_STATS.snapshot() == rbs.SKIP_STATS.snapshot()


# ---------------------------------------------------------------------------
# Layer entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["walk", "gemm"])
@pytest.mark.parametrize("n_bits", [8, 4])
@pytest.mark.parametrize("rows", [(), (7,), (2, 3)])
@pytest.mark.parametrize("K", KS)
def test_nc_dot(K, rows, n_bits, engine):
    rng = np.random.default_rng(K * 10 + n_bits + len(rows))
    x = rng.integers(0, 1 << n_bits, size=rows + (K,))
    w = rng.integers(0, 1 << n_bits, size=rows + (K,))
    ref, rc = rnc.nc_dot(x.astype(np.uint32), w.astype(np.uint32),
                         acc_bits=32, n_bits=n_bits)
    tbk.dispatch_stats_clear()
    got, tc = tnc.nc_dot(_t(x), _t(w), acc_bits=32, n_bits=n_bits,
                         engine=engine)
    assert tc == rc
    assert tuple(got.shape) == np.asarray(ref).shape == rows
    assert (got.numpy() == np.asarray(ref)).all()
    assert (got.numpy() == (x * w).sum(axis=-1)).all()
    assert tbk.dispatch_stats()[engine] == {"native": 1, "fallback": 0}


def test_nc_dot_gemm_launch_route(monkeypatch):
    """Paired rows reach the kernel entry once per diagonal block: the W4A4
    route for 4-bit operands, the 8-bit one otherwise."""
    calls = []
    real = tops.bitserial_matmul_exact

    def spy(x_q, planes, *, n_bits, w4a4=False):
        calls.append((w4a4, tuple(x_q.shape)))
        return real(x_q, planes, n_bits=n_bits, w4a4=w4a4)

    monkeypatch.setattr(tops, "bitserial_matmul_exact", spy)
    monkeypatch.setattr(tbk, "PAIR_BLOCK", 4)
    rng = np.random.default_rng(1)
    for n_bits in (8, 4):
        x = rng.integers(0, 1 << n_bits, size=(9, 40))
        w = rng.integers(0, 1 << n_bits, size=(9, 40))
        got, _ = tnc.nc_dot(_t(x), _t(w), n_bits=n_bits, engine="gemm")
        assert (got.numpy() == (x * w).sum(axis=-1)).all()
    assert [c[0] for c in calls] == [False] * 3 + [True] * 3
    assert calls[2][1] == (1, 40) and calls[5][1] == (1, 20)


def test_nc_dot_default_acc_bits():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, size=(4, 2048))
    w = rng.integers(0, 256, size=(4, 2048))
    ref, rc = rnc.nc_dot(x.astype(np.uint32), w.astype(np.uint32))
    for engine in ("walk", "gemm"):
        got, tc = tnc.nc_dot(_t(x), _t(w), engine=engine)
        assert tc == rc and (got.numpy() == np.asarray(ref)).all()


@pytest.mark.parametrize("mult,zp", [(0.01, 0), (0.37, 5), (3e-6, 3),
                                     (0.999, 0)])
def test_nc_relu_requant(mult, zp):
    """Against the reference in its int64 mode (its own tests enable x64:
    in JAX's 32-bit mode ``acc * m`` wraps)."""
    rng = np.random.default_rng(int(mult * 1000) + zp)
    acc = rng.integers(-(1 << 20), 1 << 20, size=(3, 41)).astype(np.int32)
    acc[0, :5] = [-500, -1, 0, 100, 100000]
    with jax.enable_x64(True):
        ref = np.asarray(rnc.nc_relu_requant(jnp.asarray(acc), mult, zp))
    got = tnc.nc_relu_requant(torch.from_numpy(acc), mult, zp)
    assert got.dtype == torch.uint8 and (got.numpy() == ref).all()


@pytest.mark.parametrize("mult,zp", [(0.01, 0), (0.37, 5), (1.5, 3)])
def test_requantize_reference(mult, zp):
    rng = np.random.default_rng(7)
    acc = rng.integers(-(1 << 12), 1 << 12, size=(64,)).astype(np.int32)
    acc[:4] = [50, 150, 250, -250]  # x.5 ties under mult=0.01
    ref = np.asarray(rq.requantize_reference(jnp.asarray(acc),
                                             jnp.float32(mult), zp))
    got = tq.requantize_reference(torch.from_numpy(acc), mult, zp)
    assert got.dtype == torch.int32 and (got.numpy() == ref).all()


@pytest.mark.parametrize("planes", [(0,), (3,), (0, 1), (2, 5, 7), (7,)])
@pytest.mark.parametrize("stride", [1, 2])
def test_per_plane_pruning_through_walk(planes, stride):
    """The reference's per-plane pruning case (weights whose live bits sit
    in a few planes): ``walk`` elides the dead shifted-add steps, results
    bit-identical with elision off, ``SKIP_STATS`` equal to ``host``'s."""
    rng = np.random.default_rng(sum(1 << p for p in planes) * 3 + stride)
    keep = sum(1 << p for p in planes)
    wq = (rng.integers(0, 256, size=(3, 3, 2, 4)) & keep).astype(np.uint8)
    x = rng.normal(size=(7, 7, 2)).astype(np.float32)
    r_x = rq.choose_qparams(jnp.float32(x.min()), jnp.float32(x.max()))
    r_w = rq.QuantParams(scale=np.float32(0.05), zero_point=0)
    t_x = tq.choose_qparams(float(x.min()), float(x.max()))
    t_w = tq.QuantParams(scale=float(np.float32(0.05)), zero_point=0)
    _zero_skip(True)
    ref, rc = rnc.nc_conv2d(x, wq, r_x, r_w, stride, engine="host")
    got, tc = tnc.nc_conv2d(torch.from_numpy(x), torch.from_numpy(wq), t_x,
                            t_w, stride, engine="walk")
    assert (got.numpy() == np.asarray(ref)).all() and tc == rc
    snap = tbs.SKIP_STATS.snapshot()
    assert snap == rbs.SKIP_STATS.snapshot()
    assert snap["planes_total"] > 0
    dead = 8 - len(planes)
    assert snap["planes_skipped"] >= snap["planes_total"] // 8 * dead
    tbs.ZERO_SKIP = False
    off, c_off = tnc.nc_conv2d(torch.from_numpy(x), torch.from_numpy(wq),
                               t_x, t_w, stride, engine="walk")
    assert torch.equal(off, got) and c_off == tc


# ---------------------------------------------------------------------------
# The reference's kernel entry points in kernels.ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("unpacked", [False, True])
@pytest.mark.parametrize("n_bits", [8, 3])
def test_ops_bitserial_matmul(n_bits, unpacked):
    rng = np.random.default_rng(n_bits)
    lo = -(1 << (n_bits - 1))
    x = rng.integers(-128, 128, size=(5, 37)).astype(np.int8)
    w = rng.integers(lo, -lo, size=(37, 9)).astype(np.int8)
    ws = rng.random(9).astype(np.float32)
    if unpacked:
        rp = rref.pack_bitplanes(jnp.asarray(w), n_bits)
        tp = torch.from_numpy(np.array(rp))
        kw = {}
    else:
        rp = rops.pack_weights(jnp.asarray(w), n_bits)
        tp = tops.pack_weights(torch.from_numpy(w), n_bits)
        assert (np.asarray(rp) == tp.numpy()).all()
        kw = dict(n_bits=n_bits)
    ref = np.asarray(rops.bitserial_matmul(jnp.asarray(x), rp,
                                           jnp.float32(0.5), jnp.asarray(ws),
                                           **kw))
    got = tops.bitserial_matmul(torch.from_numpy(x), tp, 0.5,
                                torch.from_numpy(ws), **kw)
    assert got.dtype == torch.float32 and (got.numpy() == ref).all()


def test_ops_bitserial_matmul_a4_and_pack_activations():
    rng = np.random.default_rng(4)
    x = rng.integers(-8, 8, size=(5, 37)).astype(np.int8)
    w = rng.integers(-8, 8, size=(37, 9)).astype(np.int8)
    ws = rng.random(9).astype(np.float32)
    r_nib = rops.pack_activations(jnp.asarray(x))
    t_nib = tops.pack_activations(torch.from_numpy(x))
    assert (np.asarray(r_nib) == t_nib.numpy()).all()
    ref = np.asarray(rops.bitserial_matmul_a4(
        r_nib, rops.pack_weights(jnp.asarray(w), 4), jnp.float32(0.5),
        jnp.asarray(ws), k=37))
    got = tops.bitserial_matmul_a4(t_nib, tops.pack_weights(
        torch.from_numpy(w), 4), 0.5, torch.from_numpy(ws), k=37)
    assert (got.numpy() == ref).all()
    with pytest.raises(ValueError, match="k=36"):
        tops.bitserial_matmul_a4(t_nib, tops.pack_weights(
            torch.from_numpy(w), 4), 0.5, torch.from_numpy(ws), k=36)


def test_ops_quant_matmul_xla():
    rng = np.random.default_rng(5)
    x = rng.integers(-128, 128, size=(6, 70)).astype(np.int8)
    w = rng.integers(-128, 128, size=(70, 11)).astype(np.int8)
    ws = rng.random(11).astype(np.float32)
    b = rng.standard_normal(11).astype(np.float32)
    for args in ((), (0.25, ws), (0.25, ws, b)):
        r_args = tuple(jnp.asarray(a) for a in args)
        t_args = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray)
                       else a for a in args)
        oracle = np.asarray(rref.quant_matmul_ref(jnp.asarray(x),
                                                  jnp.asarray(w), *r_args))
        jitted = np.asarray(rops.quant_matmul_xla(jnp.asarray(x),
                                                  jnp.asarray(w), *r_args))
        got = tops.quant_matmul_xla(torch.from_numpy(x), torch.from_numpy(w),
                                    *t_args).numpy()
        assert (got == oracle).all()
        ulp = np.spacing(np.abs(oracle).astype(np.float32))
        assert (np.abs(got - jitted) <= ulp).all()
    assert tbsm.bitserial_matmul.launches == 0  # CPU tensors: plain versions
