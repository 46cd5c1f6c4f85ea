"""The rows route of a convolution's bulk dot (``nc_layers._dot_rows``).

On a CUDA tensor an unchecked ``gemm`` convolution hands its uint8 window
and filter rows to the bit-serial GEMM kernel directly; everywhere else its
dot goes through the row-aligned words (``packed_dot_words``), which the
``gemm`` backend decodes back to the same integers.

On the CPU: the rows route's own function (``backends._gemm_dot_rows``,
which reaches the kernel's plain version on a CPU tensor) against the word
route at K = 9 (rows sharing a word) and 288, 8 and 4 bits and signed int64
windows; the shared operand rule against ``_gemm_fallback_reason`` on word
grids; a CPU convolution staying on the words (one ``packed_dot_words``
call, which the benchmark's ``dot`` reading wraps); and a traced forward's
``dot`` spans, one a layer, carrying no route and no row count (both are
recorded on the card only, where both routes run, as ``minmax.tree``'s
route is).

On a card (the ``gpu`` fixture skips without one): ``nc_conv2d`` and
``nc_fc`` on the card against the same call on the CPU, byte for byte, with
equal cycles, ``ConvStats``, plans and dispatch counts, on the rows route
(VALID and SAME, K = 9 and 288, W4A4, signed windows, a pruned compressed
plan with equal CSR bytes, the FC) and on the words where the card keeps
them (integrity, ``walk``, more than 8 planes); a reduced Inception forward
giving the CPU's logits and reports; and a traced served batch whose
``dot`` spans read ``route: rows`` and count every row fed, with the host
syncs of ``PERF.md`` less the word decode's row test.
"""
import copy
import json
import pathlib
import sys

import pytest
import torch

from repro_torch import tracing
from repro_torch.core import backends
from repro_torch.core import bitserial as bs
from repro_torch.core import nc_layers as nc
from repro_torch.core import quantize as q

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _rows(shape, bits, seed, signed=False, dtype=torch.uint8):
    """Random ``bits``-wide integers: uint8 low bytes, or int64 two's
    complement values when ``signed``."""
    g = torch.Generator().manual_seed(seed)
    if signed:
        lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int64)
    return torch.randint(0, 1 << bits, shape, generator=g).to(dtype)


# ---------------------------------------------------------------------------
# On the CPU.
# ---------------------------------------------------------------------------
@pytest.fixture
def routes(monkeypatch):
    """Counts of the two routes' entries: ``{"words", "rows"}``."""
    calls = {"words": 0, "rows": 0}
    real_words, real_rows = bs.packed_dot_words, backends._gemm_dot_rows

    def words(*a, **k):
        calls["words"] += 1
        return real_words(*a, **k)

    def rows(*a, **k):
        calls["rows"] += 1
        return real_rows(*a, **k)

    monkeypatch.setattr(bs, "packed_dot_words", words)
    monkeypatch.setattr(backends, "_gemm_dot_rows", rows)
    return calls


@pytest.mark.parametrize("K", [9, 16, 27, 288])
@pytest.mark.parametrize("bits,signed", [(8, False), (4, False), (8, True),
                                         (4, True)])
def test_rows_route_equals_the_word_route(K, bits, signed):
    """``_dot_rows`` with and without the filter words: the words decode to
    the rows' low bits, so both give the same int64 dots."""
    T, M = 37, 6
    win = _rows((T, K), bits, seed=K + bits, signed=signed)
    w_rows = _rows((M, K), bits, seed=K * bits + 1, signed=signed)
    ww = nc._pack_w_rows(w_rows, bits)
    kw = dict(x_bits=bits, w_bits=bits, K=K, acc_bits=32, engine="gemm")
    backends.dispatch_stats_clear()
    words = nc._dot_rows(win, w_rows, ww, **kw)
    rows = nc._dot_rows(win, w_rows, None, **kw)
    assert rows.dtype == words.dtype == torch.int64
    assert rows.shape == words.shape == (T, M)
    assert torch.equal(rows, words)
    mask = (1 << bits) - 1
    truth = (win.to(torch.int64) & mask) @ (w_rows.to(torch.int64) & mask).t()
    assert torch.equal(rows, truth)
    assert backends.dispatch_stats()["gemm"] == {"native": 2, "fallback": 0}


@pytest.mark.parametrize("nx,nw,K,acc_bits", [
    (8, 8, 288, 32), (4, 4, 9, 32), (9, 8, 27, 32), (8, 12, 27, 32),
    (8, 8, 288, 15), (8, 8, 33_100, 32), (8, 8, 33_000, 32), (1, 1, 5, 2),
    (2, 2, 5, 3)])
def test_operand_rule_agrees_with_the_word_fallback(nx, nw, K, acc_bits):
    """The rule the rows route is held to is ``_gemm_fallback_reason``'s
    on word grids of the same planes (more than 8 planes, an accumulator
    narrower than the product, an int32 overflow past K = 33,025 at 8
    bits); the grids' ranks are the words' own."""
    P, wpr, r = bs._row_layout(K)
    xw = torch.zeros((nx, 1, 3, wpr), dtype=torch.int64)
    ww = torch.zeros((nw, 2, 1, wpr), dtype=torch.int64)
    reason = backends._gemm_operand_reason(nx, nw, K=K, acc_bits=acc_bits)
    assert reason == backends._gemm_fallback_reason(xw, ww, K=K,
                                                    acc_bits=acc_bits)
    assert (reason is None) == (nx <= 8 and nw <= 8 and acc_bits >= nx + nw
                                and K * ((1 << nx) - 1) * ((1 << nw) - 1)
                                < 1 << 31)
    if reason is None:
        assert backends._gemm_fallback_reason(
            xw, ww[..., 0], K=K, acc_bits=acc_bits) == "grid ranks differ"


def _conv_case(K_kind, bits=8, signed=False, seed=0, B=2):
    """Integer operands of a small convolution: ``(x, w, x_qp, w_qp)``,
    K = 9 (one channel, rows sharing a word) or 288 (32 channels)."""
    C = 1 if K_kind == 9 else 32
    x = _rows((B, 7, 6, C), bits, seed=seed, signed=signed)
    if not signed:
        x = x.to(torch.int64)
    w = _rows((3, 3, C, 10), bits, seed=seed + 1)
    x_qp = q.QuantParams(0.02, -3 if signed else 5, bits=bits, signed=signed)
    w_qp = q.QuantParams(0.01, 7 % (1 << bits), bits=bits)
    return x, w, x_qp, w_qp


def test_cpu_convolution_stays_on_the_words(routes):
    x, w, x_qp, w_qp = _conv_case(288)
    nc.nc_conv2d(x, w, x_qp, w_qp, engine="gemm")
    nc.nc_fc(x.reshape(2, -1)[:, :50], w.reshape(-1, 10)[:50], x_qp, w_qp)
    assert routes == {"words": 2, "rows": 0}


def test_traced_cpu_forward_marks_no_route():
    from repro_torch.models import inception

    cfg = inception.reduced_config()
    params = inception.init_params(torch.Generator().manual_seed(0),
                                   config=cfg, device="cpu")
    x = torch.rand((2, cfg.img, cfg.img, 3),
                   generator=torch.Generator().manual_seed(1))
    with tracing.session():
        _, report = inception.nc_forward(params, x, config=cfg, device="cpu")
    s = tracing.last_session()
    dots = [i for i, r in enumerate(s.records) if r[0] == "dot"]
    layers = [r for r in report.layers if r.kind in ("conv", "fc")]
    assert len(dots) == len(layers)
    assert not any(i in s.attrs for i in dots)  # one route on the CPU
    assert "dot.rows" not in s.counters().get("dot", {})


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def gpu():
    """Skips (decided at run time, not at collection) without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the rows route runs kernel 1, "
                    "which is CUDA C++ and runs only on the card")
    return torch.device("cuda")


def _on(dev, fn, x, w, *args, **kw):
    """``fn`` on ``dev`` (filters handed over on the host), with the
    dispatch counts it made and its results on the CPU."""
    backends.dispatch_stats_clear()
    out = fn(x.to(dev), w, *args, return_stats=True, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return (out[0].cpu(),) + tuple(out[1:]) + (backends.dispatch_stats(),)


def _same(got, want):
    (g, gc, gs, gd), (v, vc, vs, vd) = got, want
    assert g.dtype == v.dtype and torch.equal(g, v)
    assert gc == vc
    assert gs == vs and gs.plan == vs.plan
    assert gd == vd


CARD_CASES = {
    "valid_k288": dict(K=288),
    "same_k288_stride2": dict(K=288, padding="SAME", stride=2),
    "valid_k9": dict(K=9),
    "same_k9": dict(K=9, padding="SAME"),
    "w4a4_k288": dict(K=288, bits=4),
    "w4a4_k9_same": dict(K=9, bits=4, padding="SAME"),
    "signed_k288": dict(K=288, signed=True),
    "signed_w4a4_k9": dict(K=9, bits=4, signed=True),
}


@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_card_rows_route_gives_the_cpu_words(case, gpu, routes):
    kw = dict(CARD_CASES[case])
    K_kind, bits, signed = (kw.pop("K"), kw.pop("bits", 8),
                            kw.pop("signed", False))
    x, w, x_qp, w_qp = _conv_case(K_kind, bits, signed, seed=len(case))
    want = _on(CPU, nc.nc_conv2d, x, w, x_qp, w_qp, **kw)
    assert routes == {"words": 1, "rows": 0}
    got = _on(gpu, nc.nc_conv2d, x, w, x_qp, w_qp, **kw)
    assert routes == {"words": 1, "rows": 1}
    _same(got, want)


def test_card_pruned_compressed_plan_gives_the_cpu_words(gpu, routes):
    x, w, x_qp, w_qp = _conv_case(288, seed=3)
    w[..., 5:] = w_qp.zero_point  # the last half of the filters pruned
    kw = dict(occupancy="detect", compressed=True, padding="SAME")
    want = _on(CPU, nc.nc_conv2d, x, w, x_qp, w_qp, **kw)
    got = _on(gpu, nc.nc_conv2d, x, w, x_qp, w_qp, **kw)
    assert routes == {"words": 1, "rows": 1}
    _same(got, want)
    stats = got[2]
    assert stats.zero_filters == 5 and stats.compressed
    assert stats.csr_payload_bytes > 0 and stats.csr_index_bytes > 0


def test_card_fc_gives_the_cpu_words(gpu, routes):
    x = _rows((3, 200), 8, seed=11).to(torch.int64)
    w = _rows((200, 17), 8, seed=12)
    x_qp, w_qp = q.QuantParams(0.1, 9), q.QuantParams(0.05, 130)
    want = _on(CPU, nc.nc_fc, x, w, x_qp, w_qp)
    got = _on(gpu, nc.nc_fc, x, w, x_qp, w_qp)
    assert routes == {"words": 1, "rows": 1}
    _same(got, want)


@pytest.mark.parametrize("case", ["integrity", "walk", "planes12"])
def test_card_keeps_the_words_where_they_are_read(case, gpu, routes):
    bits = 12 if case == "planes12" else 8
    x, w, x_qp, w_qp = _conv_case(9, bits=8, seed=21)
    if bits == 12:
        x_qp = q.QuantParams(0.02, 5, bits=12)
        x = x * 13  # values past a byte
    kw = dict(padding="SAME")
    if case == "integrity":
        kw["integrity"] = True
    if case == "walk":
        kw["engine"] = "walk"
    bs.SKIP_STATS.reset()
    want = _on(CPU, nc.nc_conv2d, x, w, x_qp, w_qp, **kw)
    skips = bs.SKIP_STATS.snapshot()
    bs.SKIP_STATS.reset()
    got = _on(gpu, nc.nc_conv2d, x, w, x_qp, w_qp, **kw)
    assert routes["rows"] == 0 and routes["words"] >= 2
    assert bs.SKIP_STATS.snapshot() == skips
    _same(got, want)
    if case == "planes12":
        assert got[3]["gemm"] == {"native": 0, "fallback": 1}


def test_card_reduced_forward_gives_the_cpu_logits(gpu, routes):
    from repro_torch.models import inception

    cfg = inception.reduced_config()
    params = {dev: inception.init_params(torch.Generator().manual_seed(0),
                                         config=cfg, device=dev)
              for dev in (CPU, gpu)}  # the same draw on each device
    x = torch.rand((2, cfg.img, cfg.img, 3),
                   generator=torch.Generator().manual_seed(1))
    want, want_report = inception.nc_forward(params[CPU], x, config=cfg,
                                             device=CPU)
    words = routes["words"]
    got, report = inception.nc_forward(params[gpu], x, config=cfg,
                                       device=gpu)
    torch.cuda.synchronize()
    layers = sum(1 for r in report.layers if r.kind in ("conv", "fc"))
    assert routes == {"words": words, "rows": layers}
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert report == want_report


def test_card_traced_batch_reads_route_rows(gpu):
    import test_torch_tracing as tt
    from ncbench import harness
    from ncbench.builders import inception as builder
    from ncbench.conftest import TINY

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell.find(copy.deepcopy(manifest), tt.CELLS[0], ROOT)
    cell.config.update(TINY)
    traffic = dict(cell.traffic, batch=2)
    params = builder.make_params(
        cell.config, torch.Generator(device=gpu).manual_seed(5), gpu)
    engine = builder.build_engine(params, cell.config, traffic, gpu)

    def serve(first_rid):
        images = builder.make_images(
            cell.config, 2, torch.Generator(device=gpu).manual_seed(11), gpu)
        for i, img in enumerate(images):
            engine.submit(builder.request(first_rid + i, img))
        assert engine.step()
        engine.completed.clear()

    serve(0)  # the warm-up batch, off
    with tracing.session():
        serve(2)
    torch.cuda.synchronize()
    s = tracing.last_session()
    dots = [i for i, r in enumerate(s.records) if r[0] == "dot"]
    assert dots and all(s.attrs.get(i) == {"route": "rows"} for i in dots)
    layers = [p.spec for p in engine._schedule_for(2).layers
              if p.spec.kind in ("conv", "fc")]
    assert len(dots) == len(layers)
    rows = sum(2 * sp.E * sp.E if sp.kind == "conv" else 2 for sp in layers)
    assert s.counters()["dot"]["dot.rows"] == rows
    # the rows route decodes nothing, so where rows share a word the word
    # decode's row test is not made
    shared = sum(1 for p in engine._schedule_for(2).layers
                 if p.spec.kind in ("conv", "fc")
                 and bs._row_layout(p.spec.R * p.spec.S * p.spec.C)[2] > 1)
    syncs = sum(c["host_syncs"] for c in s.counters().values())
    assert syncs == tt.expected_host_syncs(engine, 2) - shared
    assert s.counters()["dot"]["host_syncs"] == 0
