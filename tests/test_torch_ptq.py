"""The port's post-training quantization against ``repro.quant.ptq`` and
``repro.core.quantize``: per-channel weight quantization (2-D and stacked
3-D leaves), ``quantize_lm_params`` over the reduced ``qwen2-7b`` tree,
calibration, and the serving-path ops.

Tolerances: int8/uint8 results byte-identical and scales equal;
``CalibrationStats`` equal; ``quantized_matmul`` (weight-only and W8A8,
signed and unsigned qparams) float32 within 1 ulp; ``bitserial_linear`` at
2/4/6 bits within 1e-4 of the reference and of the dequantized oracle, as
tests/test_quant_ptq.py:46-56 checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.configs import reduced_config as rreduced
from repro.core import quantize as rq
from repro.kernels import ops as rops
from repro.models import transformer as RT
from repro.quant import ptq as rptq
from repro_torch.core import quantize as tq
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.models import transformer as TT
from repro_torch.quant import ptq as tptq

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_32_bit():
    """Some reference test modules turn x64 on process-wide; the reference
    is held here in JAX's default 32-bit mode."""
    with jax.enable_x64(False):
        yield


def _f32(seed, shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _tqp(qp):
    """A reference QuantParams as the port's (float scale, int zero point)."""
    return tq.QuantParams(scale=float(qp.scale), zero_point=int(qp.zero_point),
                          bits=qp.bits, signed=qp.signed)


# ---------------------------------------------------------------------------
# core/quantize tensor functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,axis", [((64, 48), -1), ((64, 48), 0),
                                        ((3, 40, 24), -1), ((2, 5, 16, 8), -1),
                                        ((3, 40, 24), 1)])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quantize_per_channel(shape, axis, bits):
    w = _f32(sum(shape) + bits, shape, 0.3)
    w[..., 0] = 0.0  # an all-zero channel takes scale 1
    q, s = rq.quantize_per_channel(jnp.asarray(w), axis=axis, bits=bits)
    tqv, ts = tq.quantize_per_channel(torch.from_numpy(w), axis=axis,
                                      bits=bits)
    assert tqv.dtype == torch.int8 and tuple(ts.shape) == s.shape
    assert (tqv.numpy() == np.asarray(q)).all()
    assert (ts.numpy().view(np.int32) == np.asarray(s).view(np.int32)).all()


def test_stacked_leaf_shares_one_scale_per_channel():
    """A stacked [L, K, N] leaf gets a [1, 1, N] scale shared by its L
    layers (the reference's behaviour; ROADMAP Queue 3)."""
    w = _f32(1, (3, 16, 8))
    w[1] *= 10  # layer 1 sets every channel's amax
    _, s = tq.quantize_per_channel(torch.from_numpy(w))
    assert tuple(s.shape) == (1, 1, 8)
    want = np.abs(w).max(axis=(0, 1)) / 127
    assert np.allclose(s.numpy().ravel(), want, rtol=1e-7)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_dequantize_fake_quant(signed, bits):
    x = _f32(2, (6, 33), 2.0, 0.4)
    qp = rq.choose_qparams(jnp.min(x), jnp.max(x), bits=bits, signed=signed)
    tqp = tq.choose_qparams(float(x.min()), float(x.max()), bits=bits,
                            signed=signed)
    assert tqp == _tqp(qp)
    want = np.asarray(rq.quantize(jnp.asarray(x), qp))
    got = tq.quantize(torch.from_numpy(x), tqp)
    assert got.numpy().dtype == want.dtype and (got.numpy() == want).all()
    back = tq.dequantize(got, tqp).numpy()
    assert _ulps(back, rq.dequantize(jnp.asarray(want), qp)).max() == 0
    fq = tq.fake_quant(torch.from_numpy(x), bits=bits, signed=signed)
    assert _ulps(fq.numpy(), rq.fake_quant(jnp.asarray(x), bits=bits,
                                           signed=signed)).max() == 0


@pytest.mark.parametrize("absmax", [0.0, 1e-13, 0.37, 5.0, 123.4])
@pytest.mark.parametrize("bits", [8, 4])
def test_choose_qparams_symmetric(absmax, bits):
    qp = rq.choose_qparams_symmetric(jnp.float32(absmax), bits=bits)
    assert tq.choose_qparams_symmetric(absmax, bits=bits) == _tqp(qp)


# ---------------------------------------------------------------------------
# quantize_lm_params over the reduced qwen2-7b tree
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm():
    with jax.enable_x64(False):
        cfg = rreduced(rget("qwen2-7b"))
        params = RT.init_lm(cfg, jax.random.key(0))
        pnp = jax.tree.map(np.asarray, params)
    return params, TT.params_from_jax(pnp, device="cpu")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_lm_params_leaves(lm, bits):
    params, tparams = lm
    want = dict(_paths(rptq.quantize_lm_params(params, bits=bits)))
    got = dict(_paths(tptq.quantize_lm_params(tparams, bits=bits)))
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        g = got[path]
        if path.endswith("plane_bits"):
            assert g == w == bits
            continue
        g = g.numpy()
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert (g.view(np.uint8) == w.view(np.uint8)).all(), path
    # the stacked layer leaves keep the reference's shared [1, 1, N] scale;
    # the 2-D head's scale is [N]; embeddings and norms are not quantized
    assert got["stages/0/mlp/wi/scale"].shape == (1, 1, 128)
    assert got["head/scale"].shape == (256,)
    assert "embed" in got and "stages/0/norm1/w" in got


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("momentum", [0.9, 0.5, 0.3])
def test_calibration_stats_ema(momentum):
    rs = rptq.CalibrationStats(momentum=momentum)
    ts = tptq.CalibrationStats(momentum=momentum)
    for i in range(5):
        x = _f32(i, (4, 9), 1.0 + i, 0.3 * i - 0.5)
        rs.observe("h", jnp.asarray(x))
        ts.observe("h", torch.from_numpy(x))
        rs.observe("g", jnp.asarray(-x))
        ts.observe("g", torch.from_numpy(-x))
        for name in ("h", "g"):
            assert float(ts.mins[name]) == float(rs.mins[name])
            assert float(ts.maxs[name]) == float(rs.maxs[name])
            assert ts.qparams(name) == _tqp(rs.qparams(name))


def test_calibrate_runs_batches():
    batches = [_f32(i, (3, 5)) for i in range(3)]

    def observer(to_array):
        def observe(stats, batch, out):
            stats.observe("in", to_array(batch))
            stats.observe("out", out)
        return observe

    rs = rptq.calibrate(lambda b: jnp.asarray(b) * 2, batches,
                        rptq.CalibrationStats(), observer(jnp.asarray))
    ts = tptq.calibrate(lambda b: torch.from_numpy(b) * 2, batches,
                        tptq.CalibrationStats(), observer(torch.from_numpy))
    for name in ("in", "out"):
        assert ts.qparams(name) == _tqp(rs.qparams(name))


# ---------------------------------------------------------------------------
# serving-path ops
# ---------------------------------------------------------------------------
def _wq(seed, k=64, n=48, bits=8):
    w = _f32(seed, (k, n), 0.3)
    q, s = rq.quantize_per_channel(jnp.asarray(w), axis=-1, bits=bits)
    rwq = {"q": q, "scale": s.reshape(-1)}
    twq = {"q": torch.from_numpy(np.array(q)),
           "scale": torch.from_numpy(np.array(s).reshape(-1))}
    if bits < 8:
        rwq["planes"] = rops.pack_weights(q.astype(jnp.int32), bits)
        rwq["plane_bits"] = bits
        from repro_torch.kernels import ops as tops
        twq["planes"] = tops.pack_weights(twq["q"], bits)
        twq["plane_bits"] = bits
        assert (twq["planes"].numpy() == np.asarray(rwq["planes"])).all()
    return w, rwq, twq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weight_only_quantized_matmul(seed):
    _, rwq, twq = _wq(seed)
    x = _f32(seed + 10, (8, 64))
    want = rptq.quantized_matmul(jnp.asarray(x), rwq)
    got = tptq.quantized_matmul(torch.from_numpy(x), twq)
    assert _ulps(got.numpy(), want).max() <= 1


@pytest.mark.parametrize("shape", [(8, 64), (2, 5, 64)])
@pytest.mark.parametrize("signed", [True, False])
def test_w8a8_quantized_matmul(signed, shape):
    _, rwq, twq = _wq(3)
    x = _f32(4, shape, 1.0, 0.7)
    qp = rq.choose_qparams(jnp.min(x), jnp.max(x), bits=8, signed=signed)
    before = tqm.quant_matmul.launches
    want = rptq.quantized_matmul(jnp.asarray(x), rwq, qp)
    got = tptq.quantized_matmul(torch.from_numpy(x), twq, _tqp(qp))
    assert tqm.quant_matmul.launches == before  # plain version on the CPU
    assert got.shape == want.shape
    assert _ulps(got.numpy(), want).max() <= 1
    lin = tptq.QuantizedLinear(twq, _tqp(qp))
    assert torch.equal(lin(torch.from_numpy(x)), got)


@pytest.mark.parametrize("bits", [2, 4, 6])
def test_bitserial_linear(bits):
    _, rwq, twq = _wq(4, bits=bits)
    x = _f32(5, (4, 64))
    qp = rq.choose_qparams_symmetric(jnp.max(jnp.abs(x)))
    tqp = _tqp(qp)
    want = rptq.bitserial_linear(jnp.asarray(x), rwq, qp)
    got = tptq.bitserial_linear(torch.from_numpy(x), twq, tqp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    xq = rq.quantize(jnp.asarray(x), qp).astype(jnp.float32) * qp.scale
    oracle = xq @ (rwq["q"].astype(jnp.float32) * rwq["scale"][None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-4,
                               atol=1e-4)
    lin = tptq.QuantizedLinear(twq, tqp, bits=bits)
    assert torch.equal(lin(torch.from_numpy(x)), got)


def test_bitserial_linear_unsigned_qparams():
    _, rwq, twq = _wq(6, bits=4)
    x = _f32(7, (3, 64), 1.0, 0.5)
    qp = rq.choose_qparams(jnp.min(x), jnp.max(x), bits=8)
    want = rptq.bitserial_linear(jnp.asarray(x), rwq, qp)
    got = tptq.bitserial_linear(torch.from_numpy(x), twq, _tqp(qp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
