"""The tile arithmetic of the redesigned W8A8 kernel
(``src/repro_torch/csrc/quant_gemm.cu`` on ``csrc/int8_mma.cuh``), emulated
on the CPU, and the split-K chooser its wrapper launches it with.

- The shared-memory path (any N): each staged ``[64, BN]`` tile of w rows
  is transposed to ``[n][k]`` by 4x4 byte-permute transposes, read out of
  16-byte aligned row windows by funnel shifts.  Emulated, it equals
  ``.T``; the tile's swizzled chunks keep its stores to 2- or 4-way bank
  conflicts and its fragment loads free of them.
- The register path (N % 16 == 0): w rows are staged whole with their
  16-byte chunks swizzled, ``ldmatrix .trans`` hands each thread 2x2 byte
  blocks, two byte permutes make them B fragments of even and odd columns,
  and the epilogue stores four adjacent columns a thread.  Emulated lane by
  lane, ``mma.sync.m16n8k32`` included, it equals ``x @ w``, and each 8x8
  matrix it loads lies in 8 distinct 16-byte bank groups.
- Split K: int32 partial sums of whole 64-row steps, added modulo 2^32
  (exactly, since ``|acc| <= 2^14 * K``), then the epilogue
  ``(f32(acc) * x_scale) * w_scale[n] (+ bias[n])`` rounded step by step.

Tolerances: none against ``quant_matmul_plain``, none against the JAX
kernel (interpret mode) without bias, and none against the reference's
op-by-op oracle ``ref.quant_matmul_ref`` with bias.  With bias the JAX
kernel on the CPU contracts the last multiply and the add into one fused
multiply-add, so it is held within one ulp of the product plus one ulp of
the result, as in ``tests/test_torch_quant_matmul.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.quant_matmul import quant_matmul as rqm
from repro_torch.kernels import bitserial_matmul as tk
from repro_torch.kernels import quant_matmul as tqm

torch.set_num_threads(1)

BK = 64  # the kernel's K step


@pytest.fixture(autouse=True)
def _jax_32_bit():
    with jax.enable_x64(False):
        yield


def byte_perm(a: int, b: int, sel: int) -> int:
    """CUDA's ``__byte_perm`` (no sign-replication selectors)."""
    src = a.to_bytes(4, "little") + b.to_bytes(4, "little")
    return int.from_bytes(bytes(src[(sel >> (4 * i)) & 7] for i in range(4)),
                          "little")


def word(row: bytes, at: int) -> int:
    return int.from_bytes(row[at:at + 4], "little")


def transpose4x4(r):
    """``transpose4x4`` of int8_mma.cuh."""
    t0, t1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[2], r[3], 0x5140)
    t2, t3 = byte_perm(r[0], r[1], 0x7362), byte_perm(r[2], r[3], 0x7362)
    return [byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
            byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632)]


@pytest.mark.parametrize("BN", [64, 128])
@pytest.mark.parametrize("shift", [0, 3, 8, 13])
def test_byte_permute_transpose_equals_T(BN, shift):
    """The shared-memory path: w rows in windows of BN + 16 bytes with the
    tile's first column at ``shift``, 4x4 blocks read by funnel shifts and
    transposed, give the [n][k] tile."""
    tile = np.random.default_rng(BN + shift).integers(
        -128, 128, size=(BK, BN)).astype(np.int8)
    windows = [bytes(shift) + tile[k].tobytes() + bytes(16 - shift)
               for k in range(BK)]
    ws = np.zeros((BN, BK), np.int8)
    for nq in range(0, BN, 4):
        for kq in range(0, BK, 4):
            r = []
            for j in range(4):
                at = shift + nq
                lo, hi = word(windows[kq + j], at & ~3), word(
                    windows[kq + j], (at & ~3) + 4)
                r.append(((lo | hi << 32) >> (8 * (at & 3))) & 0xFFFFFFFF)
            for j, c in enumerate(transpose4x4(r)):
                ws[nq + j, kq:kq + 4] = np.frombuffer(c.to_bytes(4, "little"),
                                                      np.int8)
    assert (ws == tile.T).all()


LDS = 80  # the decoded tile's padded row, bytes


def ws_at(n: int, k: int) -> int:
    """Where byte k of row n of the decoded tile lies in its row."""
    return 16 * ((k >> 4) ^ ((n >> 3) & 3)) + (k & 15)


@pytest.mark.parametrize("BN", [64, 128])
def test_decoded_tile_swizzle(BN):
    """The swizzled [n][k] tile holds every byte once, the decode's 4-byte
    stores (thread e writes k-word kq of rows nq..nq+3, as the kernel maps
    its blocks) meet at most 2-way (64 columns) or 4-way (128) bank
    conflicts, and each 8x8 matrix of the B fragments' ldmatrix reads 8
    consecutive rows at one chunk in 8 distinct 16-byte bank groups."""
    for n in range(BN):
        assert sorted(ws_at(n, k) for k in range(BK)) == list(range(BK))
    worst = 0
    for i in range(BK * BN // 16 // 128):
        for warp in range(4):
            for j in range(4):
                banks = {}
                for lane in range(32):
                    e = 32 * warp + lane + 128 * i
                    nq, kq = (e % (BN // 4)) * 4, (e // (BN // 4)) * 4
                    addr = (nq + j) * LDS + ws_at(nq + j, kq)
                    banks.setdefault(addr // 4 % 32, set()).add(addr)
                worst = max(worst, max(len(v) for v in banks.values()))
    assert worst == BN // 32
    for n0 in range(0, BN, 8):
        for k in (0, 16, 32, 48):
            groups = {((n0 + r) * LDS + ws_at(n0 + r, k)) // 16 % 8
                      for r in range(8)}
            assert len(groups) == 8


def direct_chunk(BN: int, r: int, c: int) -> int:
    f = (((r >> 2) & 3) | ((r & 1) << 2)) if BN == 128 else ((r >> 2) & 3)
    return c ^ f


def direct_product(x: np.ndarray, w: np.ndarray, wn: int) -> np.ndarray:
    """One warp's 16 x 32 outputs at columns wn.. of the register path,
    emulated lane by lane over one 64-row step: the staged, swizzled rows,
    ``ldmatrix.x4.trans`` at each lane's row address, the byte permutes,
    ``mma.sync.m16n8k32`` on the fragments, and the epilogue's columns."""
    BN = w.shape[1]
    sm = np.zeros((BK, BN), np.int8)
    for r in range(BK):
        for c in range(BN // 16):
            p = 16 * direct_chunk(BN, r, c)
            sm[r, p:p + 16] = w[r, 16 * c:16 * c + 16]
    out = np.zeros((16, 32), np.int64)
    for kk in (0, 32):
        for jp in range(2):
            addr = []
            for lane in range(32):
                t_row = (16 * (lane >> 4) + 4 * ((lane & 7) >> 1)
                         + 2 * ((lane >> 3) & 1) + (lane & 1))
                row = kk + t_row
                addr.append((row, 16 * direct_chunk(BN, row, wn // 16 + jp)))
            for q in range(4):  # each 8x8 matrix: 8 distinct bank groups
                groups = {((r * BN + c) // 16) % 8 for r, c in
                          addr[8 * q:8 * q + 8]}
                assert len(groups) == 8
            frags = []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                regs = []
                for q in range(4):  # .trans: rows 2t, 2t+1, b16 column g
                    (r0, c0), (r1, c1) = addr[8 * q + 2 * t], addr[8 * q + 2 * t + 1]
                    regs.append(word(sm[r0, c0 + 2 * g:c0 + 2 * g + 2].tobytes()
                                     + sm[r1, c1 + 2 * g:c1 + 2 * g + 2].tobytes(),
                                     0))
                frags.append([(byte_perm(regs[0], regs[1], sel),
                               byte_perm(regs[2], regs[3], sel))
                              for sel in (0x6420, 0x7531)])
            for e in range(2):  # n8 tile of even (0) or odd (1) columns
                acc = np.zeros((16, 8), np.int64)
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for h, b in enumerate(frags[lane][e]):
                        k = kk + 16 * h + 4 * t
                        wb = np.frombuffer(b.to_bytes(4, "little"), np.int8)
                        acc[:, g] += x[:, k:k + 4].astype(np.int64) @ wb
                for t in range(4):  # c0, c1: columns 2t, 2t+1 of the tile
                    out[:, 16 * jp + 4 * t + e] += acc[:, 2 * t]
                    out[:, 16 * jp + 4 * t + 2 + e] += acc[:, 2 * t + 1]
    return out


@pytest.mark.parametrize("wn", [0, 32, 64, 96])
def test_register_transpose_path_equals_product(wn):
    rng = np.random.default_rng(wn)
    x = rng.integers(-128, 128, size=(16, BK)).astype(np.int8)
    w = rng.integers(-128, 128, size=(BK, tqm.QUANT_TILE_N)).astype(np.int8)
    want = x.astype(np.int64) @ w[:, wn:wn + 32].astype(np.int64)
    assert (direct_product(x, w, wn) == want).all()


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(M, K)).astype(np.int8)
    w = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
    xs = np.float32(rng.uniform(0.001, 0.1))
    ws = rng.uniform(0.001, 0.1, size=(N,)).astype(np.float32)
    bias = rng.normal(size=(N,)).astype(np.float32)
    return x, w, xs, ws, bias


def epilogue(acc: torch.Tensor, xs, ws: torch.Tensor, bias):
    """The kernel's float epilogue, one rounding a step, in its order."""
    out = acc.to(torch.float32) * torch.tensor(xs, dtype=torch.float32)
    out = out * ws[None, :]
    return out if bias is None else out + bias[None, :]


# (M, K, N): split along K in 64x128 tiles, ragged N, K not a multiple of 64
SPLIT_CASES = [(1, 3584, 512), (2, 1000, 77), (17, 2593, 300),
               (5, 700, 1001), (65, 1111, 129)]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("with_bias", [False, True])
def test_split_partials_and_epilogue_equal_plain_and_pallas(case, with_bias):
    M, K, N = case
    x, w, xs, ws, bias = _operands(M, K, N, sum(case))
    splits, k_split = tqm.quant_split_k(M, N, K)
    assert splits > 1
    xt, wt = torch.from_numpy(x).to(torch.int64), torch.from_numpy(w).to(
        torch.int64)
    acc = torch.zeros((M, N), dtype=torch.int64)
    for z in reversed(range(splits)):  # any order: exact int32 sums
        lo, hi = z * k_split, min(K, (z + 1) * k_split)
        part = xt[:, lo:hi] @ wt[lo:hi]
        assert int(part.abs().max()) <= (1 << 14) * (hi - lo)
        acc += part
    assert int(acc.abs().max()) < 1 << 31
    b = torch.from_numpy(bias) if with_bias else None
    got = epilogue(acc.to(torch.int32), xs, torch.from_numpy(ws), b)
    want = tqm.quant_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  float(xs), torch.from_numpy(ws), b)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    pallas = np.asarray(rqm(jnp.asarray(x), jnp.asarray(w), xs,
                            jnp.asarray(ws),
                            jnp.asarray(bias) if with_bias else None,
                            interpret=True))
    if not with_bias:
        assert (got.numpy().view(np.int32) == pallas.view(np.int32)).all()
        return
    oracle = np.asarray(rref.quant_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), xs, jnp.asarray(ws),
        jnp.asarray(bias)))
    assert (got.numpy().view(np.int32) == oracle.view(np.int32)).all()
    prod = np.abs(acc.numpy().astype(np.float32) * xs * ws[None, :])
    tol = np.spacing(prod) + np.spacing(np.abs(pallas))
    assert (np.abs(got.numpy() - pallas) <= tol).all()


# the LM's W8A8 shapes (a 512-token prompt), the head over the 4 prompts'
# last positions, decode-sized batches, and small or empty edges
SHAPES = [(512, 3584, 3584), (512, 512, 3584), (512, 18944, 3584),
          (512, 3584, 18944), (4, 152064, 3584), (1, 3584, 3584),
          (16, 512, 3584), (64, 18944, 3584), (200, 3584, 3584),
          (1, 1, 1), (7, 5, 33), (3, 9, 64), (5, 5, 0)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_chooser_covers_k_and_fills_the_card(shape):
    M, N, K = shape
    splits, k_split = tqm.quant_split_k(M, N, K)
    tiles = -(-M // tqm.QUANT_TILE_M) * -(-N // tqm.QUANT_TILE_N)
    if splits == 1:
        assert k_split == K
        # one range: the tiles fill the card, or K has too few steps
        assert tiles >= tk.CARD_SMS or -(-K // BK) < 2 * tk.SPLIT_MIN_STEPS
        return
    assert k_split % BK == 0 and -(-K // k_split) == splits
    ranges = [(z * k_split, min(K, (z + 1) * k_split)) for z in range(splits)]
    assert ranges[-1][1] == K and all(a < b for a, b in ranges)
    # enough blocks for the card, unless each split is as short as allowed
    assert (tiles * splits >= tk.CARD_SMS
            or k_split == tk.SPLIT_MIN_STEPS * BK)


def test_split_choices_on_the_lm_path():
    """The narrow wk/wv projections split; the wide ones and the head, whose
    tiles fill the card, do not."""
    assert tqm.quant_split_k(512, 512, 3584)[0] > 1
    for M, N, K in ((512, 3584, 3584), (512, 18944, 3584),
                    (512, 3584, 18944), (4, 152064, 3584)):
        assert tqm.quant_split_k(M, N, K) == (1, K)


@pytest.fixture
def gpu():
    """Skips (decided at run time, not at collection) without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel is held against its "
                    "plain version by chip_smoke.py")
    return torch.device("cuda")


@pytest.mark.parametrize("case", SPLIT_CASES + [(4, 3584, 2048), (33, 64, 48)],
                         ids=lambda c: "x".join(map(str, c)))
def test_kernel_split_and_both_paths_on_gpu(case, gpu):
    M, K, N = case
    x, w, xs, ws, bias = _operands(M, K, N, 11 + sum(case))
    args = [torch.from_numpy(a).to(gpu) for a in (x, w, ws, bias)]
    for b in (None, args[3]):
        got = tqm.quant_matmul(args[0], args[1], float(xs), args[2], b)
        want = tqm.quant_matmul_plain(args[0], args[1], float(xs), args[2], b)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
