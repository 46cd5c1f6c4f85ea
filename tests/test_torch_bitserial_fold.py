"""The arithmetic of the tensor-core bit-serial GEMM
(``src/repro_torch/csrc/bitserial_gemm.cu``), emulated in torch on the CPU,
against ``bitserial_matmul_plain`` and the JAX Pallas kernel (interpret
mode), and the split-K chooser the wrapper launches it with.

The kernel folds the plane weights and the occupancy mask into one decoded
weight per element, ``w = sum_b pw[b] * bit_b * mask[b, k/bk, n/bn]`` (u8
for unsigned planes, s8 for signed ones), multiplies once, and wraps the
int32 sums modulo 2^32; K splits add their partial sums modulo 2^32.
:func:`fold` does the same in int64 and reduces at the end.

Tolerance: none.  int32 results are equal, and so is the float32 epilogue
``(f32(acc) * x_scale) * w_scale[n]``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitserial_matmul as rk
from repro_torch.kernels import bitserial_matmul as tk

torch.set_num_threads(1)

BK, BN = 48, 80  # mask block sizes that match no kernel tile


@pytest.fixture(autouse=True)
def _jax_32_bit():
    with jax.enable_x64(False):
        yield


def decode(planes, n_bits, signed):
    """The kernel's decode of each packed byte: the low ``n_bits`` bits as
    an unsigned number, or sign-extended from bit ``n_bits - 1``
    (``(v & (msb - 1)) - (v & msb)``)."""
    v = planes.to(torch.int64) & ((1 << n_bits) - 1)
    if not signed:
        return v
    msb = 1 << (n_bits - 1)
    return (v & (msb - 1)) - (v & msb)


def fold(x, planes, mask, n_bits, signed, bk=BK, bn=BN, k_range=None):
    """int64 ``x @ w`` of the decoded weights over ``k_range`` (all of K if
    None), unreduced."""
    K, N = planes.shape
    keep = torch.zeros((K, N), dtype=torch.int64)
    for b in range(n_bits):
        on = (torch.ones((K, N), dtype=torch.int64) if mask is None else
              mask[b].to(torch.int64).repeat_interleave(bk, 0)[:K]
              .repeat_interleave(bn, 1)[:, :N])
        keep |= on << b
    w = decode(planes.to(torch.int64) & keep, n_bits, signed)
    lo, hi = (0, K) if k_range is None else k_range
    return x.to(torch.int64)[:, lo:hi] @ w[lo:hi]


def wrap32(acc):
    return (torch.remainder(acc + (1 << 31), 1 << 32) - (1 << 31)).to(
        torch.int32)


def _operands(M, K, N, n_bits, x_signed, seed):
    rng = np.random.default_rng(seed)
    lo, hi = (-128, 128) if x_signed else (0, 256)
    x = rng.integers(lo, hi, size=(M, K)).astype(np.int8 if x_signed
                                                 else np.uint8)
    planes = rng.integers(0, 256, size=(K, N)).astype(np.uint8)
    w_scale = (rng.random(N) + 0.5).astype(np.float32)
    return x, planes, w_scale


def _mask(planes, n_bits, seed):
    full = tk.plane_block_mask(torch.from_numpy(planes), n_bits, BK, BN)
    drop = torch.from_numpy(np.random.default_rng(seed).random(
        tuple(full.shape)) < 0.3)
    return torch.where(drop, torch.zeros_like(full), full)


@pytest.mark.parametrize("n_bits", range(1, 9))
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("x_signed", [False, True])
def test_decoded_weights_fit_the_mma_operand(n_bits, signed, x_signed):
    """Every decoded weight fits u8 (unsigned planes) or s8 (signed)."""
    _, planes, _ = _operands(1, 300, 70, n_bits, x_signed, n_bits)
    w = decode(torch.from_numpy(planes), n_bits, signed)
    lo, hi = ((-(1 << (n_bits - 1)), (1 << (n_bits - 1)) - 1) if signed
              else (0, (1 << n_bits) - 1))
    assert int(w.min()) >= lo and int(w.max()) <= hi
    assert (lo, hi) == ((-128, 127) if signed else (0, 255)) or n_bits < 8


@pytest.mark.parametrize("n_bits", range(1, 9))
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("x_signed", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fold_equals_plain(n_bits, signed, x_signed, masked):
    M, K, N = 7, 203, 165  # ragged against the 128x64x64 kernel tile
    x, planes, w_scale = _operands(M, K, N, n_bits, x_signed, 10 * n_bits)
    mask = _mask(planes, n_bits, n_bits) if masked else None
    xt, pt, ws = map(torch.from_numpy, (x, planes, w_scale))
    acc = wrap32(fold(xt, pt, mask, n_bits, signed))
    kw = dict(n_bits=n_bits, signed=signed, block_k=BK, block_n=BN)
    assert torch.equal(acc, tk.bitserial_matmul_plain(
        xt, pt, 0.37, ws, mask, out_dtype=torch.int32, **kw))
    want = tk.bitserial_matmul_plain(xt, pt, 0.37, ws, mask,
                                     out_dtype=torch.float32, **kw)
    got = acc.to(torch.float32) * torch.tensor(0.37) * ws[None, :]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n_bits", range(1, 9))
def test_fold_equals_pallas_kernel(n_bits):
    signed, x_signed = n_bits % 2 == 0, n_bits % 3 == 0
    M, K, N = 5, 150, 170
    x, planes, w_scale = _operands(M, K, N, n_bits, x_signed, n_bits)
    mask = _mask(planes, n_bits, 100 + n_bits)
    want = np.asarray(rk.bitserial_matmul(
        jnp.asarray(x), jnp.asarray(planes), jnp.float32(1.0),
        jnp.asarray(w_scale), jnp.asarray(mask.numpy()), n_bits=n_bits,
        bk=BK, bn=BN, out_dtype=jnp.int32, interpret=True, signed=signed))
    got = wrap32(fold(torch.from_numpy(x), torch.from_numpy(planes), mask,
                      n_bits, signed))
    assert (got.numpy() == want).all()


def test_fold_wraps_like_the_int32_accumulator():
    """A sum past 2^31 wraps; float64 plane products stay exact (< 2^53)."""
    M, K, N = 3, 40000, 5
    x = torch.full((M, K), 255, dtype=torch.uint8)
    planes = torch.full((K, N), 255, dtype=torch.uint8)
    acc = fold(x, planes, None, 8, False)
    assert int(acc.max()) > 2 ** 31 and int(acc.max()) < 2 ** 53
    want = tk.bitserial_matmul_plain(x, planes, n_bits=8, signed=False,
                                     out_dtype=torch.int32)
    assert torch.equal(wrap32(acc), want)
    splits, k_split = tk.split_k(M, N, K)
    parts = sum(fold(x, planes, None, 8, False,
                     k_range=(z * k_split, min(K, (z + 1) * k_split)))
                for z in range(splits))
    assert splits > 1 and torch.equal(wrap32(parts), want)


# (M, N, K): the main path's Inception GEMMs at batch 2, the 4-bit PTQ
# sites, the chip check's split-K shapes, and small or empty edges
SHAPES = [(43218, 64, 288), (10082, 192, 720), (578, 384, 2592),
          (2, 1001, 2048), (512, 3584, 3584), (512, 512, 3584),
          (512, 18944, 3584), (512, 3584, 18944), (1, 300, 2048),
          (17, 1001, 2593), (2, 18944, 2048), (64, 64, 1024), (3, 5, 40000),
          (1, 1, 1), (7, 5, 33), (5, 5, 0), (0, 7, 4096)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_k_covers_k(shape):
    M, N, K = shape
    splits, k_split = tk.split_k(M, N, K)
    assert splits >= 1
    if splits == 1:
        assert k_split == K
        return
    assert k_split % tk.TILE_K == 0
    ranges = [(z * k_split, min(K, (z + 1) * k_split)) for z in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a < b for a, b in ranges)  # none is empty
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    # the kernel derives the split count back from k_split
    assert -(-K // k_split) == splits


def test_split_k_choices_on_the_main_path():
    """The FC (M = 2) and Mixed_6a split; the large convolutions fill the
    card without; a few rows over a long K always split."""
    assert tk.split_k(2, 1001, 2048)[0] > 1
    assert tk.split_k(578, 384, 2592)[0] > 1
    assert tk.split_k(43218, 64, 288)[0] == 1
    assert tk.split_k(10082, 192, 720)[0] == 1
    for M in (1, 2, 17, 64):
        assert tk.split_k(M, 18944, 1024)[0] > 1


@pytest.mark.parametrize("shape", [(2, 1001, 2048), (17, 300, 2593),
                                   (1, 70, 1100)],
                         ids=lambda s: "x".join(map(str, s)))
def test_split_partials_add_to_the_whole(shape):
    """Each split's partial sums, added modulo 2^32 in any order, give the
    unsplit result."""
    M, N, K = shape
    x, planes, _ = _operands(M, K, N, 8, True, M + K)
    xt, pt = torch.from_numpy(x), torch.from_numpy(planes)
    splits, k_split = tk.split_k(M, N, K)
    assert splits > 1
    parts = [wrap32(fold(xt, pt, None, 8, True,
                         k_range=(z * k_split, min(K, (z + 1) * k_split))))
             for z in range(splits)]
    total = torch.zeros((M, N), dtype=torch.int64)
    for part in reversed(parts):
        total = total + part.to(torch.int64)
    want = tk.bitserial_matmul_plain(xt, pt, n_bits=8, signed=True,
                                     out_dtype=torch.int32)
    assert torch.equal(wrap32(total), want)
