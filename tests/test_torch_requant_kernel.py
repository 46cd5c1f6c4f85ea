"""The §IV-D requantization of a whole batch: ``kernels.requant_rows`` (the
Hopper kernel and its plain version) and the batched host qparams that feed
it.

On the CPU: the plain version byte for byte against itself one image at a
time and the formula in numpy, on int64 staging with negatives and int32
extremes and on uint8 branch activations with an input zero point,
at B in {1, 2, 5, 64}, at every shift ``fixed_point_multiplier`` yields for
multipliers from 1e-9 to 1, written at a channel offset into a wider
output, with its live counts; the shift range's raise; the CPU route
launching nothing; ``choose_qparams_rows`` and
``fixed_point_multiplier_rows`` against the scalar calls over 10^5 float32
values with the powers of two and their neighbours; the block chooser; and
``chip_smoke.py``'s hold of a main-path run to one launch a convolution and
a branch.  On a card (the ``gpu`` fixture skips without one): the kernel
against the plain version byte for byte at Conv2d_2b's full-width output at
B = 64 and at a Mixed_7c branch, live counts equal, one launch a call, and
a reduced-width ``nc_forward`` that launches it once a convolution and a
branch and gives the plain version's logits and reports.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import quantize as q  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import requant_rows as rq  # noqa: E402
from repro_torch.models import inception  # noqa: E402

torch.set_num_threads(1)

BATCHES = [1, 2, 5, 64]
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _staging(B: int, P: int, C: int, seed: int) -> torch.Tensor:
    """int64 ``[B, P, C]``: signed 32-bit values with the extremes planted,
    and small ones, so that outputs land inside and outside 0..255."""
    rng = np.random.default_rng(seed)
    x = rng.integers(INT32_MIN, INT32_MAX, size=(B, P, C), dtype=np.int64)
    x[..., ::3] >>= 20
    x.reshape(-1)[0], x.reshape(-1)[-1] = INT32_MIN, INT32_MAX
    if x.size > 2:
        x.reshape(-1)[1] = 0
    return torch.from_numpy(x)


def _reals(B: int, seed: int) -> list[float]:
    rng = np.random.default_rng(seed)
    return [float(np.float32(10 ** rng.uniform(-9, 0))) for _ in range(B)]


def _numpy_image(acc: torch.Tensor, real: float, zp: int) -> torch.Tensor:
    """One image by the formula in numpy's int64, apart from the torch
    code under test."""
    m, s = q.fixed_point_multiplier(real)
    a = acc.numpy().astype(np.int64)
    return torch.from_numpy(np.clip(((a * m + (1 << (s - 1))) >> s) + zp,
                                    0, 255).astype(np.uint8))


def _one_image(acc: torch.Tensor, real: float, zp: int) -> torch.Tensor:
    """One image's staging requantized alone: the plain version over one
    row of one channel."""
    mult, shift = q.fixed_point_multiplier(real)
    out = torch.empty(acc.shape, dtype=torch.uint8)
    rq.requant_rows_plain(acc.reshape(1, -1, 1), out.view(1, -1, 1), 0, mult,
                          shift, zp)
    return out


def _rows(reals):
    ms = [q.fixed_point_multiplier(r) for r in reals]
    return [m for m, _ in ms], [s for _, s in ms]


@pytest.mark.parametrize("B", BATCHES)
def test_plain_matches_requant_image_on_int64_staging(B):
    x = _staging(B, 6, 7, seed=B)
    reals = _reals(B, seed=B + 1)
    zps = [int(z) for z in np.random.default_rng(B).integers(0, 256, B)]
    mult, shift = _rows(reals)
    out = torch.empty((B, 6, 7), dtype=torch.uint8)
    live = rq.requant_rows_plain(x, out, 0, mult, shift, zps, live=True)
    for b in range(B):
        want = _one_image(x[b], reals[b], zps[b])
        assert torch.equal(out[b], want)
        assert torch.equal(want, _numpy_image(x[b], reals[b], zps[b]))
        assert int(live[b]) == int((want != zps[b]).sum())
    assert live.dtype == torch.int64 and live.shape == (B,)


@pytest.mark.parametrize("B", BATCHES)
def test_plain_matches_requant_image_on_uint8_branches(B):
    """A concatenation's branch: ``(y - zp_in)`` requantized to the block's
    zero point, written at its channel offset of a wider output."""
    rng = np.random.default_rng(100 + B)
    y = torch.from_numpy(rng.integers(0, 256, (B, 5, 16), dtype=np.uint8))
    in_zp = [int(z) for z in rng.integers(0, 256, B)]
    out_zp = [int(z) for z in rng.integers(0, 256, B)]
    reals = [float(np.float32(r)) for r in rng.uniform(0.05, 3.0, B)]
    mult, shift = _rows(reals)
    out = torch.full((B, 5, 40), 77, dtype=torch.uint8)
    assert rq.requant_rows_plain(y, out, in_zp, mult, shift, out_zp,
                                 offset=16) is None
    for b in range(B):
        acc = y[b].to(torch.int64) - in_zp[b]
        want = _one_image(acc, reals[b], out_zp[b])
        assert torch.equal(out[b, :, 16:32], want)
        assert torch.equal(want, _numpy_image(acc, reals[b], out_zp[b]))
    assert bool((out[..., :16] == 77).all() and (out[..., 32:] == 77).all())


def test_every_shift_of_the_multipliers_from_1e_9_to_1():
    reals = [float(np.float32(r)) for r in np.geomspace(1e-9, 1.0, 400)]
    by_shift = {}
    for r in reals:
        by_shift.setdefault(q.fixed_point_multiplier(r)[1], r)
    assert set(by_shift) == set(range(31, 61))
    x = _staging(len(by_shift), 4, 9, seed=7)
    reals = list(by_shift.values())
    mult, shift = _rows(reals)
    out = torch.empty(x.shape, dtype=torch.uint8)
    rq.requant_rows_plain(x, out, 0, mult, shift, 3)
    for b, r in enumerate(reals):
        assert torch.equal(out[b], _one_image(x[b], r, 3))
        assert torch.equal(out[b], _numpy_image(x[b], r, 3))


@pytest.mark.parametrize("shift", [0, 64, 70])
def test_a_shift_outside_1_to_63_raises(shift):
    x = _staging(2, 3, 4, seed=1)
    out = torch.empty(x.shape, dtype=torch.uint8)
    with pytest.raises(ValueError, match="1..63"):
        rq.requant_rows_plain(x, out, 0, [1 << 30] * 2, [31, shift], 0)
    with pytest.raises(ValueError, match="1..63"):  # one row at shift 70
        rq.requant_rows_plain(x[:1], out[:1], 0,
                              *q.fixed_point_multiplier(1e-12), 0)


def test_shift_63_is_taken():
    x = _staging(1, 3, 4, seed=2)
    out = torch.empty(x.shape, dtype=torch.uint8)
    rq.requant_rows_plain(x, out, 0, 1 << 30, 63, 5)
    want = torch.clamp(((x * (1 << 30) + (1 << 62)) >> 63) + 5, 0, 255)
    assert torch.equal(out, want.to(torch.uint8))


def test_cpu_route_launches_nothing():
    before = rq.requant_rows.launches
    x = _staging(3, 4, 8, seed=3)
    a = torch.empty(x.shape, dtype=torch.uint8)
    b = torch.empty(x.shape, dtype=torch.uint8)
    mult, shift = _rows(_reals(3, seed=4))
    got = ops.requant_rows(x, a, 0, mult, shift, [1, 2, 3], live=True)
    want = rq.requant_rows_plain(x, b, 0, mult, shift, [1, 2, 3], live=True)
    assert torch.equal(a, b) and torch.equal(got, want)
    assert rq.requant_rows.launches == before


@pytest.mark.parametrize("x,out,offset,err", [
    (torch.zeros((2, 3), dtype=torch.int64),
     torch.zeros((2, 3, 1), dtype=torch.uint8), 0, "B, P, C"),
    (torch.zeros((2, 3, 4), dtype=torch.int32),
     torch.zeros((2, 3, 4), dtype=torch.uint8), 0, "int64 or uint8"),
    (torch.zeros((2, 3, 4), dtype=torch.int64),
     torch.zeros((2, 3, 4), dtype=torch.int64), 0, "out must be uint8"),
    (torch.zeros((2, 3, 4), dtype=torch.int64),
     torch.zeros((2, 4, 4), dtype=torch.uint8), 0, "out must be uint8"),
    (torch.zeros((2, 3, 4), dtype=torch.int64),
     torch.zeros((2, 3, 6), dtype=torch.uint8), 3, "outside"),
    (torch.zeros((2, 3, 4), dtype=torch.int64),
     torch.zeros((2, 3, 6), dtype=torch.uint8), -1, "outside"),
])
def test_bad_operands_raise(x, out, offset, err):
    with pytest.raises(ValueError, match=err):
        rq.requant_rows(x, out, 0, 1 << 30, 31, 0, offset)


def _sweep_values() -> np.ndarray:
    """10^5 float32 values: every power of two from 2^-40 to 2^8 with three
    neighbours on each side, the rest log-uniform over 1e-9 .. 300."""
    near = []
    for e in range(-40, 9):
        p = np.float32(2.0 ** e)
        for toward in (np.float32(0), np.float32(np.inf)):
            v = p
            for _ in range(3):
                v = np.nextafter(v, toward)
                near.append(v)
        near.append(p)
    rng = np.random.default_rng(29)
    rest = (10 ** rng.uniform(-9, np.log10(300), 10 ** 5 - len(near)))
    return np.concatenate([np.array(near, np.float32),
                           rest.astype(np.float32)])


def test_batched_multipliers_equal_the_scalar_calls():
    vals = _sweep_values()
    assert vals.size == 10 ** 5
    m, s = q.fixed_point_multiplier_rows(torch.from_numpy(vals))
    assert m.dtype == s.dtype == torch.int64
    got = list(zip(m.tolist(), s.tolist()))
    want = [q.fixed_point_multiplier(float(v)) for v in vals]
    assert got == want


def test_batched_qparams_equal_the_scalar_calls():
    """Ranges as the epilogue makes them: an int32 min or max times a
    float32 scale product, rounded to float32; zero and one-sided ranges
    included."""
    rng = np.random.default_rng(30)
    n = 10 ** 5
    sxw = rng.uniform(1e-7, 1e-2, n).astype(np.float32).astype(np.float64)
    mn = rng.integers(INT32_MIN, 1 << 20, n) * (rng.random(n) < 0.5)
    mx = rng.integers(0, INT32_MAX, n)
    mx[:100] = 0
    mn[50:150] = 0
    lo = torch.from_numpy(mn * sxw).to(torch.float32)
    hi = torch.from_numpy(mx * sxw).to(torch.float32)
    scale, zp = q.choose_qparams_rows(lo, hi)
    assert scale.dtype == torch.float32 and zp.dtype == torch.int64
    got = list(zip(scale.tolist(), zp.tolist()))
    want = [(qp.scale, qp.zero_point) for qp in
            (q.choose_qparams(float(a) * float(w), float(b) * float(w))
             for a, b, w in zip(mn, mx, sxw))]
    assert got == want


@pytest.mark.parametrize("B,n", [(1, 1), (1, 1_382_976 * 1), (64, 1_382_976),
                                 (64, 64 * 64), (4, 20_480), (2048, 8)])
def test_blocks_fill_the_card_without_idle_threads(B, n):
    blocks = rq.requant_blocks(B, n)
    assert blocks >= 1
    assert blocks == 1 or (blocks - 1) * 8 * rq.REQUANT_THREADS < n
    full = B * blocks >= rq.REQUANT_TARGET_BLOCKS
    assert full or blocks == -(-n // (8 * rq.REQUANT_THREADS))


@pytest.mark.parametrize("launches,forwards,dev,held", [
    (288, 2, "cuda", True), (144, 1, "cuda", True), (0, 0, "cuda", True),
    (6016, 1, "cuda", False), (143, 1, "cuda", False), (0, 3, "cpu", True),
    (17, None, "cuda", True)])
def test_smoke_holds_a_card_path_to_one_launch_a_layer(launches, forwards,
                                                       dev, held,
                                                       monkeypatch):
    """``chip_smoke.py`` counts each main-path run from zero and holds the
    full-width ones on the card to 94 + 50 launches a forward."""
    monkeypatch.setattr(rq.requant_rows, "launches", launches)
    monkeypatch.setattr(cs, "REQUANT_BY_PATH", {"serve": 5})
    if held:
        assert cs._requant_take("serve", torch.device(dev),
                                forwards) == launches
        assert cs.REQUANT_BY_PATH == {"serve": 5 + launches}
    else:
        with pytest.raises(AssertionError, match="want 144 a forward"):
            cs._requant_take("serve", torch.device(dev), forwards)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def gpu():
    """Skips (decided at run time, not at collection) without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the requantization kernel is CUDA "
                    "C++ and runs only on the card")
    return torch.device("cuda")


def _card_case(x, Ctot, offset, in_zp, reals, out_zp, gpu):
    """The kernel and the plain version on the same card operands, into
    outputs filled alike: equal bytes everywhere, equal live counts."""
    mult, shift = _rows(reals)
    B, P, _ = x.shape
    xd = x.to(gpu)
    got = torch.full((B, P, Ctot), 201, dtype=torch.uint8, device=gpu)
    want = got.clone()
    before = rq.requant_rows.launches
    live = rq.requant_rows(xd, got, in_zp, mult, shift, out_zp, offset,
                           live=True)
    torch.cuda.synchronize()
    assert rq.requant_rows.launches == before + 1
    want_live = rq.requant_rows_plain(xd, want, in_zp, mult, shift, out_zp,
                                      offset, live=True)
    assert live.device.type == "cuda" and live.dtype == torch.int64
    assert torch.equal(got, want)
    assert torch.equal(live, want_live)


@pytest.mark.parametrize("B,P,C,Ctot,offset", [
    (64, 147 * 147, 64, 64, 0),  # Conv2d_2b_3x3's full-width output
    (1, 1, 1, 1, 0), (3, 5, 7, 7, 0), (2, 9, 7, 20, 13), (5, 3, 16, 40, 8),
    (64, 35 * 35, 96, 96, 0)])
def test_kernel_matches_plain_on_int64_staging_on_gpu(B, P, C, Ctot, offset,
                                                      gpu):
    x = _staging(B, P, C, seed=B + P + C)
    reals = _reals(B, seed=C)
    zps = [int(z) for z in np.random.default_rng(B).integers(0, 256, B)]
    _card_case(x, Ctot, offset, 0, reals, zps, gpu)


@pytest.mark.parametrize("B", [4, 64])
def test_kernel_matches_plain_on_a_mixed_7c_block_on_gpu(B, gpu):
    """Mixed_7c's four branches, 320 + 768 + 768 + 192 channels of 8 x 8,
    each into its slice of the block's 2048."""
    rng = np.random.default_rng(B)
    offset = 0
    for C in (320, 768, 768, 192):
        y = torch.from_numpy(rng.integers(0, 256, (B, 64, C), dtype=np.uint8))
        in_zp = [int(z) for z in rng.integers(0, 256, B)]
        out_zp = [int(z) for z in rng.integers(0, 256, B)]
        reals = [float(np.float32(r)) for r in rng.uniform(0.05, 3.0, B)]
        _card_case(y, 2048, offset, in_zp, reals, out_zp, gpu)
        offset += C


def test_reduced_forward_launches_once_a_layer_on_gpu(gpu, monkeypatch):
    cfg = inception.reduced_config()
    params = inception.init_params(torch.Generator().manual_seed(0),
                                   config=cfg, device=gpu)
    x = torch.rand((2, cfg.img, cfg.img, 3),
                   generator=torch.Generator().manual_seed(1))
    before = rq.requant_rows.launches
    logits, report = inception.nc_forward(params, x, config=cfg, device=gpu)
    torch.cuda.synchronize()
    assert rq.requant_rows.launches - before == 41 + 22
    monkeypatch.setattr(ops, "requant_rows", rq.requant_rows_plain)
    plain, plain_report = inception.nc_forward(params, x, config=cfg,
                                               device=gpu)
    assert rq.requant_rows.launches - before == 41 + 22
    assert torch.equal(logits.view(torch.int32), plain.view(torch.int32))
    assert report == plain_report
