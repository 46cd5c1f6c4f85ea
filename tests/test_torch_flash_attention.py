"""The flash-attention kernel's plain torch version against the JAX Pallas
kernel ``flash_attention`` (interpret mode) and the naive oracle
``ref.flash_attention_ref``.

Tolerances:
- float32: rtol = atol = 1e-5 against the JAX kernel at the cases of
  tests/test_kernels_flash.py (MHA, GQA, MQA; causal and not; its tile
  sweep), with the same KV tiles on both sides (the online recurrence is
  the same, only the order of float32 sums inside a tile differs);
- float32 against the oracle at ragged Tq/Tk, which the JAX kernel refuses:
  rtol = atol = 1e-5;
- bfloat16: rtol = atol = 2e-2, as tests/test_kernels_flash.py:47.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``; ``test_kernel_matches_plain_on_gpu`` repeats that check
where a GPU exists, with its tolerances: float32 rtol = atol = 1e-5;
bfloat16 rtol = 2^-7 (one bf16 ulp: both round the same float32 result
once) and atol = 1e-5 (where cancellation leaves an output near zero, the
order of the float32 sums decides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention as rfa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_32_bit():
    """Some reference test modules turn x64 on process-wide; the reference
    is held here in JAX's default 32-bit mode."""
    with jax.enable_x64(False):
        yield


def _qkv(B, H, Hkv, Tq, Tk, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Tq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Tk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Tk, D)).astype(np.float32)
    return q, k, v


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# tests/test_kernels_flash.py's cases: MHA square, GQA rectangular, MQA
CASES = [(1, 4, 4, 256, 256, 64), (2, 8, 2, 256, 512, 64),
         (1, 2, 1, 512, 512, 128)]


@pytest.mark.parametrize("tiles", [(256, 256), (64, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_pallas_kernel(case, causal, tiles):
    bq, bk = tiles
    q, k, v = _qkv(*case, seed=sum(case))
    want = np.asarray(rfa(*map(jnp.asarray, (q, k, v)), causal=causal,
                          bq=bq, bk=bk, interpret=True))
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, bq=bq, bk=bk)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("bq,bk", [(128, 128), (256, 128), (128, 512),
                                   (512, 512)])
def test_tile_sweep_matches_pallas_kernel(bq, bk):
    q, k, v = _qkv(1, 2, 2, 512, 512, 64, seed=2)
    want = np.asarray(rfa(*map(jnp.asarray, (q, k, v)), bq=bq, bk=bk,
                          interpret=True))
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    bq=bq, bk=bk)
    _close(got.numpy(), want, 1e-5)


def test_bf16_matches_pallas_kernel():
    q, k, v = _qkv(1, 2, 2, 256, 256, 64, seed=1)
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(rfa(qj, kj, vj, interpret=True), np.float32)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tfa.flash_attention_plain(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, 2e-2)
    oracle = rref.flash_attention_ref(*(a.astype(jnp.float32)
                                        for a in (qj, kj, vj)))
    _close(got.float().numpy(), np.asarray(oracle), 2e-2)


# ragged shapes the JAX kernel refuses (Tq, Tk not multiples of the tiles),
# causal with both positions counted from 0 as the oracle counts them
RAGGED = [(1, 4, 2, 100, 100, 32, True), (2, 4, 1, 37, 53, 16, False),
          (1, 6, 3, 70, 130, 64, True), (1, 2, 2, 130, 70, 16, True),
          (3, 8, 8, 1, 65, 32, False), (1, 28, 4, 129, 129, 128, True)]


@pytest.mark.parametrize("case", RAGGED, ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_oracle_at_ragged_shapes(case):
    *shape, causal = case
    q, k, v = _qkv(*shape, seed=7)
    want = np.asarray(rref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                               causal=causal))
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_runs_plain_on_cpu(causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 2, 50, 50, 16, 3))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal)
    via_ops = tops.flash_attention(q, k, v, causal=causal)
    assert tfa.flash_attention.launches == before  # the CPU never launches
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    assert torch.equal(got, want) and torch.equal(via_ops, want)


def test_rejects_bad_operands():
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 3, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k, k)
    with pytest.raises(TypeError, match="share"):
        tfa.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match=r"\[B, H, T, D\]"):
        tfa.flash_attention(q[0], q, q)


@pytest.fixture
def gpu():
    """Skips (decided at run time, not at collection) without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel is held against its "
                    "plain version by chip_smoke.py")
    return torch.device("cuda")


@pytest.mark.parametrize("case", RAGGED, ids=lambda c: "x".join(map(str, c)))
def test_kernel_matches_plain_on_gpu(case, gpu):
    *shape, causal = case
    for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-5),
                              (torch.bfloat16, 2 ** -7, 1e-5)):
        q, k, v = (torch.from_numpy(a).to(dtype).to(gpu)
                   for a in _qkv(*shape, seed=9))
        got = tfa.flash_attention(q, k, v, causal=causal)
        want = tfa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
