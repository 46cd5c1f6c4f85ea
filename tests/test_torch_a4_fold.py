"""The arithmetic of the tensor-core W4A4 kernel
(``src/repro_torch/csrc/bitserial_gemm_a4.cu`` on ``csrc/int8_mma.cuh``),
emulated in torch on the CPU, against ``bitserial_matmul_a4_plain`` and the
JAX Pallas kernel ``_kernel_a4`` (interpret mode).

The kernel stages each x row's packed bytes as the 16-byte aligned window
around them, widens each 32-bit word of 8 nibbles into two words of 4 bytes
(masks, two byte permutes, and for signed nibbles ``v | (v & 8) * 0x1E``
per byte), folds the weight planes and the mask (K-blocks of ``2 * bk2``
rows) into one u8/s8 weight per element, multiplies once with int32 sums
that wrap, and adds split-K partial sums modulo 2^32.  :func:`widen_word`,
:func:`x_window_words` and :func:`fold` do the same in torch.

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

BK2, BN = 24, 80  # mask block sizes (K-blocks of 48 rows) that match no tile
STEP = 64  # the kernel's K step (elements); 32 packed bytes a row


@pytest.fixture(autouse=True)
def _jax_32_bit():
    with jax.enable_x64(False):
        yield


def byte_perm(a: int, b: int, sel: int) -> int:
    """CUDA's ``__byte_perm`` (no sign-replication selectors)."""
    src = a.to_bytes(4, "little") + b.to_bytes(4, "little")
    return int.from_bytes(bytes(src[(sel >> (4 * i)) & 7] for i in range(4)),
                          "little")


def widen_word(v: int, signed: bool) -> tuple[int, int]:
    """``widen_nibbles``: 8 nibbles (the even element low in each byte) ->
    two words of 4 bytes in element order."""
    lo = v & 0x0F0F0F0F
    hi = (v >> 4) & 0x0F0F0F0F
    if signed:
        lo |= ((lo & 0x08080808) * 0x1E) & 0xFFFFFFFF
        hi |= ((hi & 0x08080808) * 0x1E) & 0xFFFFFFFF
    return byte_perm(lo, hi, 0x5140), byte_perm(lo, hi, 0x7362)


def to_bytes(words, signed):
    raw = b"".join(w.to_bytes(4, "little") for w in words)
    return np.frombuffer(raw, np.int8 if signed else np.uint8).astype(np.int64)


def nibbles(xp: np.ndarray, signed: bool) -> np.ndarray:
    """The elements of packed rows ``[M, K2]`` -> ``[M, 2*K2]`` int64."""
    b = xp.astype(np.int64)
    lo, hi = b & 0xF, b >> 4
    if signed:
        lo, hi = (lo ^ 8) - 8, (hi ^ 8) - 8
    return np.stack([lo, hi], axis=-1).reshape(b.shape[0], -1)


def x_window_words(flat: bytes, m: int, K2: int, k0: int) -> list[int]:
    """The 8 words the kernel widens for row m at K step k0: the 16-byte
    aligned window around bytes [m*K2 + k0/2, +32) (3 copies of 16 bytes,
    zero past the tensor's end), read at the row's offset in it."""
    first = m * K2 + k0 // 2
    at = first & ~15
    window = flat[at:at + 48].ljust(48, b"\0")
    shift = first & 15
    return [int.from_bytes(window[shift + 4 * j:shift + 4 * j + 4], "little")
            for j in range(8)]


def decode(planes, n_bits, signed):
    """The decode of each packed byte: the low ``n_bits`` bits, unsigned or
    sign-extended from bit ``n_bits - 1``."""
    v = planes.to(torch.int64) & ((1 << n_bits) - 1)
    if not signed:
        return v
    msb = 1 << (n_bits - 1)
    return (v & (msb - 1)) - (v & msb)


def fold(xw, planes, mask, n_bits, signed, bk=2 * BK2, bn=BN, k_range=None):
    """int64 ``xw @ w`` over ``k_range`` (all of K if None) of the widened
    x ``[M, >= K]`` and the folded weights (mask K-blocks of ``bk`` rows),
    unreduced; x columns at or past K meet no weight row."""
    K, N = planes.shape
    keep = torch.zeros((K, N), dtype=torch.int64)
    for b in range(n_bits):
        on = (torch.ones((K, N), dtype=torch.int64) if mask is None else
              mask[b].to(torch.int64).repeat_interleave(bk, 0)[:K]
              .repeat_interleave(bn, 1)[:, :N])
        keep |= on << b
    w = decode(planes.to(torch.int64) & keep, n_bits, signed)
    lo, hi = (0, K) if k_range is None else k_range
    return xw[:, lo:hi] @ w[lo:hi]


def wrap32(acc):
    return (torch.remainder(acc + (1 << 31), 1 << 32) - (1 << 31)).to(
        torch.int32)


def _operands(M, K2, K, N, n_bits, seed):
    rng = np.random.default_rng(seed)
    xp = rng.integers(0, 256, size=(M, K2)).astype(np.uint8)
    planes = rng.integers(0, 1 << n_bits, size=(K, N)).astype(np.uint8)
    w_scale = (rng.random(N) + 0.5).astype(np.float32)
    return xp, planes, w_scale


def _mask(planes, K2, n_bits, seed):
    """A plane mask of the a4 layout ``[n_bits, ceil(K2/bk2), ceil(N/bn)]``
    (K-blocks of 2*bk2 rows) with some blocks switched off."""
    K, N = planes.shape
    p = torch.from_numpy(planes)
    if K < 2 * K2:
        p = torch.nn.functional.pad(p, (0, 0, 0, 2 * K2 - K))
    full = tk.plane_block_mask(p, n_bits, 2 * min(BK2, K2), BN)
    drop = torch.from_numpy(np.random.default_rng(seed).random(
        tuple(full.shape)) < 0.3)
    return torch.where(drop, torch.zeros_like(full), full)


@pytest.mark.parametrize("signed", [False, True])
def test_widening_equals_unpacking(signed):
    """Every byte value in every position widens to its two elements."""
    rng = np.random.default_rng(int(signed))
    words = [int(w) for w in rng.integers(0, 1 << 32, size=256,
                                          dtype=np.uint64)]
    words += [int.from_bytes(bytes([b, 255 - b, b ^ 0x5A, 0x87]), "little")
              for b in range(256)]
    for v in words:
        packed = np.frombuffer(v.to_bytes(4, "little"), np.uint8)[None]
        got = to_bytes(widen_word(v, signed), signed)
        assert (got == nibbles(packed, signed)[0]).all()


@pytest.mark.parametrize("K2", [144, 360, 1297, 100, 107])
def test_x_windows_widen_to_the_row(K2):
    """At every K step of every row the window words widen to the row's
    elements k0..k0+63 wherever k < 2*K2, so rows of K2 bytes off a
    16-byte boundary (K2 = 360 at Conv2d_4a) need no byte loads; past the
    row the bytes belong to the next row or are zero and meet no weights."""
    M = 5
    xp = np.random.default_rng(K2).integers(0, 256, size=(M, K2)).astype(
        np.uint8)
    flat = xp.tobytes()
    want = nibbles(xp, signed=True)
    for m in range(M):
        for k0 in range(0, 2 * K2, STEP):
            words = x_window_words(flat, m, K2, k0)
            got = to_bytes([w for v in words for w in widen_word(v, True)],
                           True)
            n = min(STEP, 2 * K2 - k0)
            assert (got[:n] == want[m, k0:k0 + n]).all()
            if m == M - 1 and n < STEP:  # past the tensor: zero bytes
                assert (got[n:] == 0).all()


# (M, K2, K, N, n_bits): odd K, K < 2*K2 - 1, K2 off a 16-byte boundary,
# ragged against the 128x64x64 tile
CASES = [(7, 102, 203, 165, 1), (130, 17, 33, 70, 2), (5, 200, 301, 77, 3),
         (65, 150, 300, 129, 4), (3, 360, 719, 40, 4), (1, 33, 20, 9, 2)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("x_signed", [False, True])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fold_equals_plain(case, x_signed, signed, masked):
    """The widened, folded product equals the plain version: the a4 one
    where nibbles and planes share a signedness, else the 8-bit one on the
    widened nibbles (the same function; the a4 wrapper passes one flag for
    both)."""
    M, K2, K, N, n_bits = case
    xp, planes, w_scale = _operands(M, K2, K, N, n_bits, sum(case))
    mask = _mask(planes, K2, n_bits, M) if masked else None
    xw = torch.from_numpy(nibbles(xp, x_signed))
    pt, ws = torch.from_numpy(planes), torch.from_numpy(w_scale)
    acc = wrap32(fold(xw, pt, mask, n_bits, signed))
    got_f = acc.to(torch.float32) * torch.tensor(0.37) * ws[None, :]
    for out_dtype, got in ((torch.int32, acc), (torch.float32, got_f)):
        if x_signed == signed:
            want = tk.bitserial_matmul_a4_plain(
                torch.from_numpy(xp), pt, 0.37, ws, mask, n_bits=n_bits,
                out_dtype=out_dtype, signed=signed, block_k2=BK2,
                block_n=BN)
        else:
            # the 8-bit plain version's mask K-blocks are the same 2*bk2
            # rows; the a4 mask's blocks past K cover only zero rows
            x8 = xw[:, :K].to(torch.int8 if x_signed else torch.uint8)
            bk = 2 * min(BK2, K2)
            m8 = None if mask is None else mask[:, :-(-K // min(bk, K))]
            want = tk.bitserial_matmul_plain(
                x8, pt, 0.37, ws, m8, n_bits=n_bits, out_dtype=out_dtype,
                signed=signed, block_k=bk, block_n=BN)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("signed", [False, True])
def test_fold_equals_pallas_kernel(case, signed):
    M, K2, K, N, n_bits = case
    xp, planes, w_scale = _operands(M, K2, K, N, n_bits, 7 + sum(case))
    # the reference's mask over its padded planes, K-blocks of 2*bk2 rows
    bk2, bn = min(BK2, K2), min(BN, N)
    mask = _mask(planes, K2, n_bits, N)
    pk2, pn = -(-K2 // bk2), -(-N // bn)
    assert tuple(mask.shape) == (n_bits, pk2, pn)
    want = np.asarray(rk.bitserial_matmul_a4(
        jnp.asarray(xp), jnp.asarray(planes), jnp.float32(1.0),
        jnp.asarray(w_scale), jnp.asarray(mask.numpy()), n_bits=n_bits,
        bm=64, bn=bn, bk2=bk2, out_dtype=jnp.int32, interpret=True,
        signed=signed))
    xw = torch.from_numpy(nibbles(xp, signed))
    got = wrap32(fold(xw, torch.from_numpy(planes), mask, n_bits, signed,
                      bk=2 * bk2, bn=bn))
    assert (got.numpy() == want).all()


# the W4A4 shapes of the 4-bit path (batch 2) and the chip check's
# split-K shapes, as (M, K2, K, N)
A4_SHAPES = [(43218, 144, 288, 64), (10082, 360, 720, 192),
             (578, 1296, 2592, 384), (2, 1024, 2048, 1001),
             (1, 1024, 2048, 300), (17, 1297, 2593, 1001),
             (2, 1300, 1500, 1001), (7, 200, 301, 77)]


@pytest.mark.parametrize("shape", A4_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_split_partials_add_to_the_whole(shape):
    """Each split's partial sums (ranges of whole 64-row steps of the
    weights; x bytes from k_begin/2) added modulo 2^32 in any order give
    the unsplit result, and the ranges cover K with none empty."""
    M, K2, K, N = shape
    splits, k_split = tk.split_k(M, N, K)
    if splits == 1:
        assert k_split == K
        return
    ranges = [(z * k_split, min(K, (z + 1) * k_split)) for z in range(splits)]
    assert k_split % STEP == 0 and ranges[-1][1] == K
    assert all(a < b for a, b in ranges)
    if M * N > 400_000:
        return  # the partial sums below are for the small shapes
    xp, planes, _ = _operands(M, K2, K, N, 4, M + K)
    xw = torch.from_numpy(nibbles(xp, True))
    pt = torch.from_numpy(planes)
    total = torch.zeros((M, N), dtype=torch.int64)
    for lo, hi in reversed(ranges):
        total += wrap32(fold(xw, pt, None, 4, True, k_range=(lo, hi))).to(
            torch.int64)
    want = tk.bitserial_matmul_a4_plain(torch.from_numpy(xp), pt, n_bits=4,
                                        signed=True, out_dtype=torch.int32)
    assert torch.equal(wrap32(total), want)


def test_split_choices_on_the_four_bit_path():
    """Mixed_6a and the FC split along K; the two large convolutions fill
    the card without."""
    assert tk.split_k(578, 384, 2592)[0] > 1
    assert tk.split_k(2, 1001, 2048)[0] > 1
    assert tk.split_k(43218, 64, 288)[0] == 1
    assert tk.split_k(10082, 192, 720)[0] == 1


@pytest.fixture
def gpu():
    """Skips (decided at run time, not at collection) without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel is held against its "
                    "plain version by chip_smoke.py")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES + [(17, 1297, 2593, 300, 4),
                                          (2, 1024, 2048, 1001, 3)],
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("signed", [False, True])
def test_a4_kernel_split_and_edges_on_gpu(case, signed, gpu):
    M, K2, K, N, n_bits = case
    xp, planes, w_scale = _operands(M, K2, K, N, n_bits, 3 + sum(case))
    args = [torch.from_numpy(a).to(gpu) for a in (xp, planes, w_scale)]
    for out_dtype in (torch.int32, torch.float32):
        kw = dict(n_bits=n_bits, signed=signed, out_dtype=out_dtype)
        got = tk.bitserial_matmul_a4(*args[:2], 0.37, args[2], **kw)
        want = tk.bitserial_matmul_a4_plain(*args[:2], 0.37, args[2], **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
