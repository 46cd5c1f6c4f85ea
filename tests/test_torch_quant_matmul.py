"""The W8A8 GEMM's plain torch version against the JAX Pallas kernel
``quant_matmul`` (interpret mode) and its oracle ``ref.quant_matmul_ref``.

Tolerances:
- int32 accumulators: equal (unit scales, no bias, |acc| < 2^24 so the
  float32 output holds the accumulator exactly);
- float32 outputs without bias: equal to the JAX kernel's to 1 ulp (both
  compute ``(f32(acc) * x_scale) * w_scale[n]`` in that order);
- float32 outputs with bias: equal bit for bit to the oracle evaluated op by
  op, which rounds ``... * w_scale[n]`` and ``+ bias[n]`` separately as the
  port does; against the JAX kernel within 1 ulp of the product
  ``acc * x_scale * w_scale[n]`` plus 1 ulp of the result, because the CPU
  interpreter contracts the last multiply and the bias add into one fused
  multiply-add (one rounding instead of two: the product's rounding error,
  at most half an ulp of the product, can move the sum's rounding by one
  ulp of the result; where the bias nearly cancels the product this is
  many ulps of the result).

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``; ``test_kernel_matches_plain_on_gpu`` repeats that check
where a GPU exists.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.quant_matmul import quant_matmul as rqm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as tqm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_32_bit():
    """Some reference test modules turn x64 on process-wide; the reference
    is held here in JAX's default 32-bit mode."""
    with jax.enable_x64(False):
        yield


# tests/test_kernels.py's SHAPES (line 29), the 200x300x100 case of its
# block-shape test (line 94) and seeded draws like its property test
# (line 103); plus K not a multiple of 4
SHAPES = [(1, 8, 8), (4, 16, 32), (128, 128, 128), (100, 130, 60),
          (256, 512, 128), (3, 1024, 5), (128, 256, 256), (200, 300, 100),
          (7, 33, 9), (33, 1, 17)]
SHAPES += [tuple(int(v) for v in np.random.default_rng(s).integers(
    1, (65, 129, 65))) for s in range(4)]


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    xs = np.float32(rng.uniform(0.001, 0.1))
    ws = rng.uniform(0.001, 0.1, size=(n,)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    return x, w, xs, ws, bias


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ulps(a, b):
    """Distance in float32 units in the last place."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("m,k,n", SHAPES, ids=lambda v: str(v))
def test_int32_accumulator_equal(m, k, n):
    x, w, *_ = _operands(m, k, n, m * 1000 + k + n)
    ones = np.ones(n, np.float32)
    exact = x.astype(np.int64) @ w.astype(np.int64)
    got = tqm.quant_matmul_plain(*_t(x, w), 1.0, torch.from_numpy(ones))
    want = np.asarray(rqm(jnp.asarray(x), jnp.asarray(w), jnp.float32(1.0),
                          jnp.asarray(ones), interpret=True))
    assert (got.numpy().astype(np.int64) == exact).all()
    assert (want.astype(np.int64) == exact).all()


@pytest.mark.parametrize("m,k,n", SHAPES, ids=lambda v: str(v))
def test_plain_matches_pallas_kernel_without_bias(m, k, n):
    x, w, xs, ws, _ = _operands(m, k, n, m + 7 * k + n)
    got = tqm.quant_matmul_plain(*_t(x, w), float(xs), torch.from_numpy(ws))
    want = np.asarray(rqm(jnp.asarray(x), jnp.asarray(w), xs,
                          jnp.asarray(ws), interpret=True))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _ulps(got.numpy(), want).max() <= 1


@pytest.mark.parametrize("blocks", [(32, 32, 32), (64, 128, 256),
                                    (128, 64, 64)])
@pytest.mark.parametrize("m,k,n", SHAPES[:8], ids=lambda v: str(v))
def test_plain_matches_pallas_kernel_with_bias(m, k, n, blocks):
    bm, bn, bk = blocks
    x, w, xs, ws, bias = _operands(m, k, n, m + 3 * k + 5 * n + bm)
    got = tqm.quant_matmul_plain(*_t(x, w), float(xs),
                                 *_t(ws, bias)).numpy()
    oracle = rref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w), xs,
                                   jnp.asarray(ws), jnp.asarray(bias))
    assert (got.view(np.int32) == np.asarray(oracle).view(np.int32)).all()
    want = np.asarray(rqm(jnp.asarray(x), jnp.asarray(w), xs,
                          jnp.asarray(ws), jnp.asarray(bias), bm=bm, bn=bn,
                          bk=bk, interpret=True))
    acc = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.float32)
    prod = np.abs((acc * xs) * ws[None, :])
    tol = np.spacing(prod) + np.spacing(np.abs(want))
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("with_bias", [False, True])
def test_wrapper_runs_plain_on_cpu(with_bias):
    x, w, xs, ws, bias = _operands(37, 70, 29, 5)
    b = torch.from_numpy(bias) if with_bias else None
    args = (*_t(x, w), float(xs), torch.from_numpy(ws), b)
    before = tqm.quant_matmul.launches
    got = tqm.quant_matmul(*args)
    via_ops = tops.quant_matmul(*args)
    assert tqm.quant_matmul.launches == before  # the CPU never launches
    want = tqm.quant_matmul_plain(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(via_ops.view(torch.int32), want.view(torch.int32))
    # the reference's CPU entry point is the oracle, as the plain version
    ref = rops.quant_matmul(jnp.asarray(x), jnp.asarray(w), xs,
                            jnp.asarray(ws))
    if not with_bias:
        assert _ulps(got.numpy(), np.asarray(ref)).max() <= 1


def test_wrapper_out_dtype_casts_the_float32_epilogue():
    """``out_dtype=`` casts the float32 epilogue, as the reference's kernel
    casts it on the way out: bit-equal to the float32 result cast, and
    within one bfloat16 ulp of the reference's (whose float32 result may
    sit one float32 ulp away, which can move the bf16 rounding by one)."""
    x, w, xs, ws, _ = _operands(37, 70, 29, 6)
    f32 = tqm.quant_matmul(*_t(x, w), float(xs), torch.from_numpy(ws))
    got = tqm.quant_matmul(*_t(x, w), float(xs), torch.from_numpy(ws),
                           out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))
    want = np.asarray(rqm(jnp.asarray(x), jnp.asarray(w), xs,
                          jnp.asarray(ws), out_dtype=jnp.bfloat16,
                          interpret=True)).astype(np.float32)
    spacing = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
    assert (np.abs(got.float().numpy() - want) <= spacing).all()


def test_rejects_bad_operands():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 3), dtype=torch.int8)
    ws = torch.ones(3)
    with pytest.raises(ValueError, match="K=8"):
        tqm.quant_matmul(x, torch.zeros((9, 3), dtype=torch.int8), 1.0, ws)
    with pytest.raises(TypeError, match="int8"):
        tqm.quant_matmul(x.to(torch.uint8), w, 1.0, ws)
    with pytest.raises(ValueError, match="w_scale"):
        tqm.quant_matmul(x, w, 1.0, torch.ones(4))
    with pytest.raises(TypeError, match="bias"):
        tqm.quant_matmul(x, w, 1.0, ws, torch.ones(3, dtype=torch.float64))


@pytest.fixture
def gpu():
    """Skips (decided at run time, not at collection) without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel is held against its "
                    "plain version by chip_smoke.py")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", SHAPES, ids=lambda v: str(v))
def test_kernel_matches_plain_on_gpu(m, k, n, gpu):
    x, w, xs, ws, bias = _operands(m, k, n, m + k + n)
    args = [a.to(gpu) for a in _t(x, w, ws, bias)]
    for b in (None, args[3]):
        got = tqm.quant_matmul(args[0], args[1], float(xs), args[2], b)
        want = tqm.quant_matmul_plain(args[0], args[1], float(xs), args[2], b)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
