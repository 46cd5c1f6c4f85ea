"""The §IV-D min/max: ``kernels.minmax_rows`` (the Hopper kernel and its
plain version, the bit-serial walk) and ``nc_minmax``'s route to it.

On the CPU: the walk's values against numpy's min and max of the same
``bits``-wide values, ``nc_minmax`` and the op taking the walk without a
launch, cycles charged from the shape, the fake implementation on ``meta``,
the block chooser, the kernel layer importing nothing of the engine, and
``chip_smoke.py``'s hold of a main-path run to one launch a convolution.
On a card (the ``gpu`` fixture skips without one):
the kernel's mins, maxs and cycles against the walk run on the same values
on the CPU, byte for byte, and a reduced-width ``nc_forward`` that launches
the kernel once a convolution, never walks, and gives the logits of the
same forward through the plain version.
"""
import ast
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.core import bitserial as bs  # noqa: E402
from repro_torch.core import nc_layers as nc  # noqa: E402
from repro_torch.kernels import minmax_rows as mm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

KERNELS = ROOT / "src" / "repro_torch" / "kernels"

BITS = [(8, False), (12, True), (32, True), (32, False)]


def _values(rows: int, K: int, bits: int, signed: bool,
            seed: int) -> torch.Tensor:
    """int64 ``[rows, K]``: random low ``bits`` under random high bits
    (values overflow the low 32 bits), with the extremes of the ``bits``-wide
    range planted at a row's last lane (a tail after the last whole 16-byte
    pair) and at the next row's first (a head before its first boundary)."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 1 << bits, size=(rows, K), dtype=np.int64)
    high = rng.integers(-(1 << 20), 1 << 20, size=(rows, K),
                        dtype=np.int64) << 32
    x = (high & ~np.int64((1 << bits) - 1)) | low
    lo, hi = (1 << (bits - 1), (1 << (bits - 1)) - 1) if signed \
        else (0, (1 << bits) - 1)  # the smallest and largest as bit patterns
    x[0, -1] = (x[0, -1] & ~np.int64((1 << bits) - 1)) | lo
    if rows > 1:
        x[1, 0] = (x[1, 0] & ~np.int64((1 << bits) - 1)) | hi
    return torch.from_numpy(x)


def _truth(x: torch.Tensor, bits: int, signed: bool):
    """The min and max of the ``bits``-wide values by numpy."""
    v = x.numpy() & np.int64((1 << bits) - 1)
    if signed:
        v = np.where(v >= 1 << (bits - 1), v - (1 << bits), v)
    return v.min(axis=1), v.max(axis=1)


@pytest.mark.parametrize("bits,signed", BITS)
@pytest.mark.parametrize("rows,K", [(1, 1), (3, 2), (4, 7), (2, 33),
                                    (5, 100)])
def test_walk_gives_the_values_min_and_max(rows, K, bits, signed):
    x = _values(rows, K, bits, signed, seed=rows * K + bits)
    mn, mx = mm.minmax_rows_plain(x, bits, signed)
    want_mn, want_mx = _truth(x, bits, signed)
    assert mn.dtype == mx.dtype == torch.int64
    np.testing.assert_array_equal(mn.numpy(), want_mn)
    np.testing.assert_array_equal(mx.numpy(), want_mx)


@pytest.mark.parametrize("bits,signed", BITS)
def test_cpu_takes_the_walk_without_a_launch(bits, signed, monkeypatch):
    walks = []
    real = bs.bitserial_minmax
    monkeypatch.setattr(bs, "bitserial_minmax",
                        lambda *a: walks.append(1) or real(*a))
    before = mm.minmax_rows.launches
    x = _values(6, 37, bits, signed, seed=5)
    got = ops.minmax_rows(x, bits, signed)
    want = mm.minmax_rows_plain(x, bits, signed)
    mn, mx, cycles = nc.nc_minmax(x.reshape(2, 3, 37), bits=bits,
                                  signed=signed)
    assert walks == [1, 1, 1] and mm.minmax_rows.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(mn, want[0].reshape(2, 3))
    assert torch.equal(mx, want[1].reshape(2, 3))
    # the walk's own count on the padded rows, and the bias's 2 cycles
    assert cycles == bs.minmax_cycles(64, bits) + 2 * signed
    assert cycles == bs.minmax_cycles(37, bits) + 2 * signed


def test_nc_minmax_keeps_its_spans_on_the_cpu():
    x = _values(2, 50, 32, True, seed=9)
    with tracing.session():
        nc.nc_minmax(x, bits=32, signed=True)
    s = tracing.last_session()
    totals = s.totals()
    assert totals["minmax"]["count"] == totals["minmax.tree"]["count"] == 1
    assert s.attrs == {}  # the route is annotated on the card only


def test_fake_gives_int64_rows_on_meta():
    x = torch.empty((5, 1000), dtype=torch.int64, device="meta")
    mn, mx = ops.minmax_rows(x, 32, True)
    for t in (mn, mx):
        assert t.device.type == "meta"
        assert t.shape == (5,) and t.dtype == torch.int64


@pytest.mark.parametrize("rows,K", [(1, 1), (1, 1_382_976), (4, 1_382_976),
                                    (64, 1_382_976), (64, 12_288),
                                    (4, 20_480), (2048, 8), (10**6, 3)])
def test_chunks_fill_the_card_without_starving_a_block(rows, K):
    chunks = mm.minmax_chunks(rows, K)
    assert chunks >= 1
    assert chunks == 1 or -(-K // chunks) >= mm.MINMAX_MIN_CHUNK // 2
    full = rows * chunks >= mm.MINMAX_TARGET_BLOCKS
    assert full or chunks == -(-K // mm.MINMAX_MIN_CHUNK)
    assert rows * (chunks - 1) < mm.MINMAX_TARGET_BLOCKS or chunks == 1


@pytest.mark.parametrize("x,bits,err", [
    (torch.zeros((2, 0), dtype=torch.int64), 32, "at least one"),
    (torch.zeros((2, 3), dtype=torch.int32), 32, "int64"),
    (torch.zeros(3, dtype=torch.int64), 32, "2-D"),
    (torch.zeros((2, 3), dtype=torch.int64), 0, "1..63"),
    (torch.zeros((2, 3), dtype=torch.int64), 64, "1..63"),
])
def test_bad_operands_raise(x, bits, err):
    with pytest.raises(ValueError, match=err):
        mm.minmax_rows(x, bits, True)


def test_kernel_modules_leave_the_engine_unimported():
    """The kernel layer stands below the engine: no module of
    ``repro_torch.kernels`` imports ``repro_torch.core`` when it is
    imported (the min/max's plain version reaches the engine's walk only
    when called)."""
    for path in sorted(KERNELS.glob("*.py")):
        tree = ast.parse(path.read_text())
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [n.module or "" for n in top if isinstance(n, ast.ImportFrom)]
        names += [a.name for n in top if isinstance(n, ast.Import)
                  for a in n.names]
        assert not [m for m in names if m.startswith("repro_torch.core")], \
            path.name


@pytest.mark.parametrize("launches,forwards,dev,held", [
    (188, 2, "cuda", True), (94, 1, "cuda", True), (0, 0, "cuda", True),
    (2834, 2, "cuda", False), (93, 1, "cuda", False), (0, 3, "cpu", True),
    (17, None, "cuda", True)])
def test_smoke_holds_a_card_path_to_one_launch_a_conv(launches, forwards,
                                                      dev, held,
                                                      monkeypatch):
    """``chip_smoke.py`` counts each main-path run from zero and holds the
    full-width ones on the card to 94 launches a forward."""
    monkeypatch.setattr(mm.minmax_rows, "launches", launches)
    monkeypatch.setattr(cs, "MINMAX_BY_PATH", {"serve": 5})
    if held:
        assert cs._minmax_take("serve", torch.device(dev),
                               forwards) == launches
        assert cs.MINMAX_BY_PATH == {"serve": 5 + launches}
    else:
        with pytest.raises(AssertionError, match="want 94 a forward"):
            cs._minmax_take("serve", torch.device(dev), forwards)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def gpu():
    """Skips (decided at run time, not at collection) without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the min/max kernel is CUDA C++ "
                    "and runs only on the card")
    return torch.device("cuda")


CARD_CASES = [(rows, K) for K in (1, 2, 7, 32, 100, 20_480, 1_382_976)
              for rows in (1, 4, 64) if rows < 64 or K <= 20_480]


@pytest.mark.parametrize("bits,signed", BITS)
@pytest.mark.parametrize("rows,K", CARD_CASES)
def test_kernel_matches_the_walk_on_gpu(rows, K, bits, signed, gpu):
    x = _values(rows, K, bits, signed, seed=rows + K + bits)
    want = nc.nc_minmax(x, bits=bits, signed=signed)
    before = mm.minmax_rows.launches
    got = nc.nc_minmax(x.to(gpu), bits=bits, signed=signed)
    torch.cuda.synchronize()
    assert mm.minmax_rows.launches == before + 1
    for g, w in zip(got[:2], want[:2]):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)
    assert got[2] == want[2]


def test_reduced_forward_launches_once_a_conv_on_gpu(gpu, monkeypatch):
    from repro_torch.models import inception

    cfg = inception.reduced_config()
    params = inception.init_params(torch.Generator().manual_seed(0),
                                   config=cfg, device=gpu)
    x = torch.rand((2, cfg.img, cfg.img, 3),
                   generator=torch.Generator().manual_seed(1))
    walks = []
    real = bs.bitserial_minmax
    monkeypatch.setattr(bs, "bitserial_minmax",
                        lambda *a: walks.append(1) or real(*a))
    before = mm.minmax_rows.launches
    logits, report = inception.nc_forward(params, x, config=cfg, device=gpu)
    torch.cuda.synchronize()
    convs = sum(1 for r in report.layers if r.kind == "conv")
    assert convs > 0 and mm.minmax_rows.launches - before == convs
    assert walks == []
    monkeypatch.setattr(ops, "minmax_rows", mm.minmax_rows_plain)
    plain, plain_report = inception.nc_forward(params, x, config=cfg,
                                               device=gpu)
    assert len(walks) == convs and mm.minmax_rows.launches - before == convs
    assert torch.equal(logits.view(torch.int32), plain.view(torch.int32))
    assert report == plain_report
