"""The port's layers against the JAX reference: outputs byte-identical,
cycles equal, ``ConvStats`` equal field for field.

The reference runs with ``engine="jit"``: its ``engine_words_*`` counters
count the host walk's zero-word elision, which neither the reference's
compiled engine nor the port performs, so they are 0 on both sides.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nc_layers as rnc
from repro.core import quantize as rq
from repro.core import schedule as rsched
from repro.core.cache_geometry import XEON_E5_35MB as RGEOM
from repro.core.mapper import LayerSpec as RSpec
from repro_torch.core import nc_layers as tnc
from repro_torch.core import quantize as tq
from repro_torch.core import schedule as tsched
from repro_torch.core.cache_geometry import XEON_E5_35MB as TGEOM

torch.set_num_threads(1)


def _stats_dict(stats):
    d = dataclasses.asdict(stats)
    plan = d.pop("plan")
    return d, plan


def _qps(lo, hi, bits):
    return (rq.choose_qparams(jnp.float32(lo), jnp.float32(hi), bits=bits),
            tq.choose_qparams(float(np.float32(lo)), float(np.float32(hi)),
                              bits=bits))


def _check_conv(x, w, bits, stride=1, padding="VALID", prune=0.0,
                engines=("gemm", "walk"), **kw):
    M = w.shape[-1]
    k = int(round(M * prune))
    r_xqp, t_xqp = _qps(0.0, 1.0, bits)
    r_wqp, t_wqp = _qps(w.min(), w.max(), bits)
    wq = np.asarray(rnc._quantize_np(w, r_wqp)).astype(np.int64)
    if k:
        wq[..., M - k:] = int(r_wqp.zero_point)  # pruned filters
    kw_r = dict(kw)
    kw_t = dict(kw)
    if prune:
        kw_r["occupancy"] = kw_t["occupancy"] = "detect"
    want, c_want, s_want = rnc.nc_conv2d(
        x, wq.astype(np.uint8), r_xqp, r_wqp, stride, padding=padding,
        engine="jit", return_stats=True, **kw_r)
    for engine in engines:
        got, c_got, s_got = tnc.nc_conv2d(
            torch.from_numpy(x), torch.from_numpy(wq.astype(np.uint8)), t_xqp,
            t_wqp, stride, padding=padding, engine=engine, return_stats=True,
            **kw_t)
        assert got.dtype == torch.int32
        assert (np.asarray(want) == got.numpy()).all(), engine
        assert c_want == c_got
        d_want, p_want = _stats_dict(s_want)
        d_got, p_got = _stats_dict(s_got)
        assert d_want == d_got
        assert p_want == p_got  # the executed plan, field for field


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
@pytest.mark.parametrize("padding,stride", [("VALID", 1), ("SAME", 1),
                                            ("VALID", 2), ("SAME", 2)])
def test_conv_bits_padding_stride(bits, padding, stride):
    rng = np.random.default_rng(bits * 10 + stride)
    x = rng.random((2, 9, 8, 5), dtype=np.float32)
    w = rng.standard_normal((3, 3, 5, 6)).astype(np.float32)
    _check_conv(x, w, bits, stride, padding)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("C", [1, 8, 20])  # K = 9C: <= 16 rows share words
def test_conv_batch_and_small_k(batch, C):
    rng = np.random.default_rng(batch + C)
    x = rng.random((batch, 7, 7, C), dtype=np.float32)
    w = rng.standard_normal((1 if C == 8 else 3, 1 if C == 8 else 3, C, 4))
    _check_conv(x, w.astype(np.float32), 8, padding="SAME")


def test_conv_unbatched_and_ragged_tiles():
    rng = np.random.default_rng(3)
    x = rng.random((11, 10, 6), dtype=np.float32)
    w = rng.standard_normal((3, 3, 6, 7)).astype(np.float32)
    _check_conv(x, w, 8, tile_pixels=13, tile_filters=3)
    _check_conv(x[None], w, 8, padding="SAME", tile_pixels=50)


@pytest.mark.parametrize("prune", [0.0, 0.5, 1.0])
def test_conv_pruning(prune):
    rng = np.random.default_rng(int(prune * 10))
    x = rng.random((2, 8, 8, 6), dtype=np.float32)
    w = rng.standard_normal((3, 3, 6, 8)).astype(np.float32)
    _check_conv(x, w, 8, padding="SAME", prune=prune)


def test_conv_float_inputs_per_image_qparams_and_overlap():
    """Float inputs quantized in-layer with per-image qparams, on a
    multi-pass layer (one-slice geometry) whose plan grants §IV-E overlap:
    the port runs it serially with the reference's results and stats."""
    rng = np.random.default_rng(7)
    x = (rng.random((2, 12, 12, 32), dtype=np.float32) * 3 - 1)
    w = rng.standard_normal((3, 3, 32, 64)).astype(np.float32)
    r_qps, t_qps = zip(*[_qps(x[b].min(), x[b].max(), 8) for b in range(2)])
    r_wqp, t_wqp = _qps(w.min(), w.max(), 8)
    spec_kw = dict(name="c", kind="conv", H=12, R=3, S=3, C=32, M=64, E=12,
                   stride=1)
    r_plan = rsched.plan_layer(RSpec(**spec_kw), RGEOM.scaled(1), batch=2,
                               overlap=True)
    t_plan = tsched.plan_layer(tsched.LayerSpec(**spec_kw), TGEOM.scaled(1),
                               batch=2, overlap=True)
    assert t_plan.overlap and t_plan.serial_passes > 1
    want, c_w, s_w = rnc.nc_conv2d(x, w, list(r_qps), r_wqp, padding="SAME",
                                   geom=RGEOM.scaled(1), plan=r_plan,
                                   engine="jit", return_stats=True)
    got, c_g, s_g = tnc.nc_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                  list(t_qps), t_wqp, padding="SAME",
                                  geom=TGEOM.scaled(1), plan=t_plan,
                                  return_stats=True)
    assert (np.asarray(want) == got.numpy()).all() and c_w == c_g
    assert _stats_dict(s_w)[0] == _stats_dict(s_g)[0]
    assert s_g.overlap


def test_conv_unported_plan_flags_raise():
    x = torch.zeros((1, 4, 4, 2), dtype=torch.uint8)
    w = torch.zeros((1, 1, 2, 2), dtype=torch.uint8)
    qp = tq.QuantParams(scale=1.0, zero_point=0)
    with pytest.raises(NotImplementedError, match="integrity"):
        tnc.nc_conv2d(x, w, qp, qp, integrity=True)
    with pytest.raises(NotImplementedError, match="CompressedPlanes"):
        tnc.nc_conv2d(x, w, qp, qp, compressed=True)


@pytest.mark.parametrize("window,stride,padding", [(3, 2, "VALID"),
                                                   (3, 1, "SAME"),
                                                   (2, 2, "SAME"),
                                                   (5, 1, "VALID")])
@pytest.mark.parametrize("batched", [False, True])
def test_pools_equal(window, stride, padding, batched):
    rng = np.random.default_rng(window + stride)
    x = rng.integers(0, 256, size=(2, 9, 10, 3)).astype(np.uint8)
    if not batched:
        x = x[0]
    for rfn, tfn in ((rnc.nc_maxpool2d, tnc.nc_maxpool2d),
                     (rnc.nc_avgpool2d, tnc.nc_avgpool2d)):
        want, c_w = rfn(x, window, stride, padding=padding)
        got, c_g = tfn(torch.from_numpy(x), window, stride, padding=padding)
        assert got.dtype == torch.uint8
        assert (np.asarray(want) == got.numpy()).all() and c_w == c_g


@pytest.mark.parametrize("K", [1, 2, 7, 32, 100])
@pytest.mark.parametrize("bits,signed", [(8, False), (32, True), (32, False)])
def test_minmax_equal(K, bits, signed):
    rng = np.random.default_rng(K + bits)
    lo, hi = (-(1 << 31), 1 << 31) if signed else (0, 1 << min(bits, 31))
    x = rng.integers(lo, hi, size=(3, K))
    mn_r, mx_r, c_r = rnc.nc_minmax(x, bits=bits, signed=signed)
    mn_t, mx_t, c_t = tnc.nc_minmax(torch.from_numpy(x), bits=bits,
                                    signed=signed)
    assert (np.asarray(mn_r) == mn_t.numpy()).all()
    assert (np.asarray(mx_r) == mx_t.numpy()).all()
    assert (mn_t.numpy() == x.min(axis=1)).all()
    assert c_r == c_t


@pytest.mark.parametrize("batched", [False, True])
def test_fc_equal(batched):
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, size=(3, 40)).astype(np.uint8)
    w = rng.integers(0, 256, size=(40, 9)).astype(np.uint8)
    qp_r, qp_t = _qps(0.0, 1.0, 8)
    xin = x if batched else x[0]
    want, c_w, s_w = rnc.nc_fc(xin, w, qp_r, qp_r, engine="jit",
                               return_stats=True)
    got, c_g, s_g = tnc.nc_fc(torch.from_numpy(xin), torch.from_numpy(w),
                              qp_t, qp_t, return_stats=True)
    assert (np.asarray(want) == got.numpy()).all() and c_w == c_g
    assert _stats_dict(s_w)[0] == _stats_dict(s_g)[0]
