"""The W4A4 bit-serial GEMM's plain torch version against the JAX Pallas
kernel ``bitserial_matmul_a4`` (interpret mode), the nibble packing against
``repro.kernels.ref``, and the W4A4 route of ``ops.bitserial_matmul_exact``.

Tolerance: none.  The int32 outputs must be equal, and so must the float32
epilogue: both packages compute ``(f32(acc) * x_scale) * w_scale[n]`` in
that order, in float32 with round-to-nearest.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``; ``test_a4_kernel_matches_plain_on_gpu`` repeats that
check where a GPU exists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitserial_matmul as rk
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import bitserial_matmul as tk
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

# (M, K, N, n_bits): odd and even K, ragged against the blocks below
CASES = [(1, 1, 1, 1), (5, 7, 3, 2), (9, 301, 17, 3), (130, 33, 129, 4),
         (3, 258, 5, 4), (17, 64, 40, 1), (8, 99, 70, 2), (33, 513, 9, 3)]
BK2, BN = 16, 32  # small blocks, so the masks hold several blocks


def _operands(M, K, N, n_bits, seed, signed):
    rng = np.random.default_rng(seed)
    lo, hi = (-8, 8) if signed else (0, 16)
    x = rng.integers(lo, hi, size=(M, K)).astype(np.int8)
    planes = rng.integers(0, 1 << n_bits, size=(K, N)).astype(np.uint8)
    w_scale = (rng.random(N) + 0.5).astype(np.float32)
    x_packed = np.asarray(rref.pack_activation_nibbles(jnp.asarray(x)))
    return x, x_packed, planes, w_scale


def _mask(planes, K2, n_bits, seed):
    """The reference's block mask over the padded planes (K-blocks of
    ``2 * BK2`` rows) with some live blocks switched off."""
    K, N = planes.shape
    bk2, bn = min(BK2, K2), min(BN, N)
    pk2, pn = (-K2) % bk2, (-N) % bn
    padded = np.pad(planes, ((0, 2 * (K2 + pk2) - K), (0, pn)))
    unpacked = rref.unpack_bitplanes_bytes(jnp.asarray(padded), n_bits)
    mask = np.asarray(rk.plane_block_mask(unpacked, 2 * bk2, bn))
    drop = np.random.default_rng(seed).random(mask.shape) < 0.4
    return np.where(drop, 0, mask).astype(np.int8)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_equals_pallas_kernel(case, signed, masked):
    M, K, N, n_bits = case
    _, xp, planes, w_scale = _operands(M, K, N, n_bits, sum(case), signed)
    mask = _mask(planes, xp.shape[1], n_bits, M) if masked else None
    kw = dict(n_bits=n_bits, signed=signed)
    args = [torch.from_numpy(a.copy()) for a in (xp, planes)]
    ws = torch.from_numpy(w_scale)
    tmask = None if mask is None else torch.from_numpy(mask)
    for out_dtype, jdt in ((torch.int32, jnp.int32),
                           (torch.float32, jnp.float32)):
        want = np.asarray(rk.bitserial_matmul_a4(
            jnp.asarray(xp), jnp.asarray(planes), jnp.float32(0.37),
            jnp.asarray(w_scale), None if mask is None else jnp.asarray(mask),
            bm=64, bn=BN, bk2=BK2, out_dtype=jdt, interpret=True, **kw))
        got = tk.bitserial_matmul_a4_plain(*args, 0.37, ws, tmask,
                                           out_dtype=out_dtype, block_k2=BK2,
                                           block_n=BN, **kw)
        # the wrapper takes the plain version for CPU tensors
        via_wrapper = tk.bitserial_matmul_a4(*args, 0.37, ws, tmask,
                                             out_dtype=out_dtype,
                                             block_k2=BK2, block_n=BN, **kw)
        assert got.dtype == out_dtype
        assert (got.numpy().view(np.int32) == want.view(np.int32)).all()
        assert torch.equal(got, via_wrapper)


@pytest.mark.parametrize("K", [1, 2, 7, 8, 301])
def test_nibble_pack_roundtrip(K):
    rng = np.random.default_rng(K)
    x = rng.integers(-8, 8, size=(5, K)).astype(np.int8)
    packed = tk.pack_activation_nibbles(torch.from_numpy(x))
    want = np.asarray(rref.pack_activation_nibbles(jnp.asarray(x)))
    assert packed.dtype == torch.uint8 and (packed.numpy() == want).all()
    back = tk.unpack_activation_nibbles(packed, K)
    assert back.dtype == torch.int8 and (back.numpy() == x).all()
    ref_back = rref.unpack_activation_nibbles(jnp.asarray(want), K)
    assert (np.asarray(ref_back) == back.numpy()).all()
    u = rng.integers(0, 16, size=(3, K))
    assert ((tk.unpack_activation_nibbles(
        tk.pack_activation_nibbles(torch.from_numpy(u)), K).numpy() & 0xF)
        == u).all()


@pytest.mark.parametrize("case", CASES[1:], ids=lambda c: "x".join(map(str, c)))
def test_exact_w4a4_entry_equals_reference_ops(case):
    """The ``gemm`` backend's entry: unsigned nibbles and planes, exact
    int32, equal to the reference's W4A4 route and to the 8-bit kernel on
    the unpacked activations."""
    M, K, N, n_bits = case
    x, xp, planes, _ = _operands(M, K, N, n_bits, M + N, False)
    want = np.asarray(rops.bitserial_matmul_exact(
        jnp.asarray(xp), jnp.asarray(planes), n_bits=n_bits, w4a4=True))
    got = tops.bitserial_matmul_exact(torch.from_numpy(xp.copy()),
                                      torch.from_numpy(planes),
                                      n_bits=n_bits, w4a4=True)
    assert got.dtype == torch.int32 and (got.numpy() == want).all()
    eight = tops.bitserial_matmul_exact(torch.from_numpy(x.view(np.uint8)),
                                        torch.from_numpy(planes),
                                        n_bits=n_bits)
    assert torch.equal(got, eight)


def test_a4_wrapper_rejects_bad_operands():
    xp = torch.zeros((4, 4), dtype=torch.uint8)
    planes = torch.zeros((7, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="K=9"):
        tk.bitserial_matmul_a4(xp, torch.zeros((9, 3), dtype=torch.uint8))
    with pytest.raises(TypeError, match="nibble-packed uint8"):
        tk.bitserial_matmul_a4(xp.to(torch.int8), planes)
    with pytest.raises(ValueError, match="n_bits"):
        tk.bitserial_matmul_a4(xp, planes, n_bits=5)
    with pytest.raises(ValueError, match="plane_mask"):
        tk.bitserial_matmul_a4(xp, planes, plane_mask=torch.ones(
            (4, 2, 2), dtype=torch.int8))


@pytest.fixture
def gpu():
    """Skips (decided at run time, not at collection) without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the W4A4 kernel is held against "
                    "its plain version by chip_smoke.py")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_a4_kernel_matches_plain_on_gpu(case, gpu):
    M, K, N, n_bits = case
    for signed in (False, True):
        for masked in (False, True):
            _, xp, planes, w_scale = _operands(M, K, N, n_bits, M, signed)
            mask = _mask(planes, xp.shape[1], n_bits, N) if masked else None
            args = [torch.from_numpy(a.copy()).to(gpu)
                    for a in (xp, planes, w_scale)]
            tmask = None if mask is None else torch.from_numpy(mask).to(gpu)
            for out_dtype in (torch.int32, torch.float32):
                kw = dict(n_bits=n_bits, signed=signed, out_dtype=out_dtype,
                          block_k2=BK2, block_n=BN)
                got = tk.bitserial_matmul_a4(args[0], args[1], 0.37, args[2],
                                             tmask, **kw)
                want = tk.bitserial_matmul_a4_plain(args[0], args[1], 0.37,
                                                    args[2], tmask, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
