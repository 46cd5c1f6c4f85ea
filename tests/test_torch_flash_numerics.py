"""The arithmetic of the bf16 tensor-core flash-attention kernel
(``src/repro_torch/csrc/flash_attention.cu``), emulated in torch on the CPU,
against ``flash_attention_plain`` and the JAX Pallas kernel (interpret mode).

The kernel multiplies bf16 Q by bf16 K^T with float32 accumulation (each
product is exact in float32, only the order of the sums differs), scales
and masks the float32 scores, keeps the running max and sum in float32,
takes ``p = 2^((s - m) * log2 e)`` and splits it into ``hi = bf16(p)`` and
``lo = bf16(p - hi)`` for two float32-accumulated P.V products; ``l`` is
summed from the float32 p.  :func:`emulate` does the same over KV tiles of
the kernel's width.

Tolerances:
- emulation vs the plain version (bf16 in and out): rtol = 2^-7 (one bf16
  ulp: both round nearly the same float32 value once) and atol = 1e-5, the
  bound ``chip_smoke.py`` holds the kernel to (``FA_BF16_RTOL``,
  ``FA_BF16_ATOL``); outputs near cancellation make the atol side count;
- emulation vs the JAX kernel on bf16 inputs: 2e-2, as
  tests/test_kernels_flash.py holds its bf16 kernel;
- rounding p to bf16 alone (SDPA's arithmetic) must fail the first bound on
  a seeded case near cancellation: that is what the hi + lo split is for.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as rfa
from repro_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)

BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-5
KERNEL_BKV = 32  # keys per KV tile of the bf16 kernel
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def _jax_32_bit():
    """Some reference test modules turn x64 on process-wide; the reference
    is held here in JAX's default 32-bit mode."""
    with jax.enable_x64(False):
        yield


def emulate(q, k, v, *, causal=True, bkv=KERNEL_BKV, split=True):
    """The bf16 kernel's arithmetic on bf16 ``q`` [B, H, Tq, D] and ``k``,
    ``v`` [B, Hkv, Tk, D]; ``split=False`` rounds p to bf16 alone."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    f32 = torch.float32
    qf = q.to(f32).reshape(B, Hkv, H // Hkv, Tq, D)
    kf, vf = k.to(f32), v.to(f32)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=f32)
    log2e = torch.tensor(LOG2E, dtype=f32)
    m = torch.full(qf.shape[:4], tfa.NEG_INF, dtype=f32)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    qpos = torch.arange(Tq)
    for j0 in range(0, Tk, bkv):
        kj, vj = kf[:, :, j0:j0 + bkv], vf[:, :, j0:j0 + bkv]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kj) * scale
        if causal:
            kpos = torch.arange(j0, j0 + kj.shape[2])
            s = torch.where(kpos[None, :] <= qpos[:, None], s,
                            torch.tensor(tfa.NEG_INF, dtype=f32))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp2((s - m_new[..., None]) * log2e)
        c = torch.exp2((m - m_new) * log2e)
        l = l * c + p.sum(dim=-1)
        m = m_new
        acc = acc * c[..., None]
        if split:
            hi = p.to(torch.bfloat16).to(f32)
            lo = (p - hi).to(torch.bfloat16).to(f32)
            acc = acc + torch.einsum("bhgqk,bhkd->bhgqd", hi, vj)
            acc = acc + torch.einsum("bhgqk,bhkd->bhgqd", lo, vj)
        else:
            acc = acc + torch.einsum("bhgqk,bhkd->bhgqd",
                                     p.to(torch.bfloat16).to(f32), vj)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, Tq, D).to(torch.bfloat16)


def _qkv(B, H, Hkv, Tq, Tk, D, seed, q_std=1.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(scale=q_std, size=(B, H, Tq, D))
    k = rng.normal(size=(B, Hkv, Tk, D))
    v = rng.normal(size=(B, Hkv, Tk, D))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                 for a in (q, k, v))


def _excess(got, want):
    """Largest amount by which |got - want| exceeds the bf16 bound."""
    g, w = got.double(), want.double()
    return ((g - w).abs() - (BF16_ATOL + BF16_RTOL * w.abs())).max().item()


# (B, H, Hkv, Tq, Tk, D, causal): GQA and MHA, causal and full, Tq and Tk
# ragged against the kernel's 64-row query and 32-key KV tiles, every
# served head size class
CASES = [(1, 4, 2, 100, 100, 16, True), (2, 4, 1, 37, 53, 16, False),
         (1, 6, 3, 70, 130, 64, True), (1, 2, 2, 130, 70, 64, True),
         (1, 7, 1, 65, 65, 64, False), (1, 14, 2, 129, 129, 128, True),
         (2, 4, 4, 33, 97, 128, False), (1, 7, 1, 96, 31, 128, True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_emulation_within_one_ulp_of_plain(case):
    *shape, causal = case
    q, k, v = _qkv(*shape, seed=sum(shape))
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    got = emulate(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _excess(got, want) <= 0.0


# shapes the JAX kernel takes (Tq, Tk multiples of its tiles)
JAX_CASES = [(1, 4, 2, 128, 128, 16, True), (1, 4, 4, 64, 128, 64, False),
             (1, 7, 1, 128, 128, 128, True), (2, 2, 1, 64, 64, 128, False)]


@pytest.mark.parametrize("case", JAX_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_emulation_matches_pallas_kernel(case):
    *shape, causal = case
    q, k, v = _qkv(*shape, seed=3 + sum(shape))
    as_jax = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in (q, k, v)]
    want = np.asarray(rfa(*as_jax, causal=causal, bq=64, bk=64,
                          interpret=True), np.float32)
    got = emulate(q, k, v, causal=causal).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def _near_cancellation(seed):
    """Small scores (nearly uniform p over many keys) against V whose
    columns sum to zero exactly: every output is a near-cancellation of
    terms of size |v| = 1."""
    B, H, Hkv, T, D = 1, 4, 2, 256, 64
    q, k, _ = _qkv(B, H, Hkv, T, T, D, seed, q_std=0.5)
    signs = np.tile([1.0, -1.0], T // 2)
    rng = np.random.default_rng(seed + 1)
    v = np.stack([rng.permutation(signs) for _ in range(B * Hkv * D)])
    v = v.reshape(B, Hkv, D, T).transpose(0, 1, 3, 2)
    return q, k, torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
def test_split_holds_near_cancellation_and_bf16_p_does_not(causal):
    fails = 0
    for seed in range(3):
        q, k, v = _near_cancellation(seed)
        want = tfa.flash_attention_plain(q, k, v, causal=causal)
        assert _excess(emulate(q, k, v, causal=causal), want) <= 0.0
        fails += _excess(emulate(q, k, v, causal=causal, split=False),
                         want) > 0.0
    assert fails >= 1


@pytest.mark.parametrize("bkv", [16, 32, 64])
def test_tiles_above_the_diagonal_add_nothing(bkv):
    """The kernel stops a query tile's KV walk at its last row; keys past
    that, fully masked, leave m, l and acc bit-identical."""
    q, k, v = _qkv(1, 2, 1, 64, 256, 64, seed=5)
    full = emulate(q, k, v, causal=True, bkv=bkv)
    stopped = emulate(q, k[:, :, :64], v[:, :, :64], causal=True, bkv=bkv)
    assert torch.equal(full, stopped)
