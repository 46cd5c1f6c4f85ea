"""The bit-serial GEMM's plain torch version against the JAX Pallas kernel
(interpret mode) and ``ops.bitserial_matmul_exact``.

Tolerance: none.  The int32 outputs must be equal, and so must the float32
epilogue: both packages compute ``(f32(acc) * x_scale) * w_scale[n]`` in
that order, in float32 with round-to-nearest.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``; ``test_kernel_matches_plain_on_gpu`` repeats that check
where a GPU exists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitserial_matmul as rk
from repro.kernels import ops as rops
from repro_torch.kernels import bitserial_matmul as tk
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

# (M, K, N, n_bits): ragged edges against the reference's 128/256/128 blocks
CASES = [(1, 1, 1, 1), (5, 7, 3, 2), (9, 300, 17, 3), (130, 33, 129, 4),
         (3, 257, 5, 5), (17, 64, 200, 6), (33, 513, 9, 7), (8, 100, 40, 8)]


def _operands(M, K, N, n_bits, seed, x_signed):
    rng = np.random.default_rng(seed)
    lo, hi = (-128, 128) if x_signed else (0, 256)
    x = rng.integers(lo, hi, size=(M, K)).astype(np.int8 if x_signed else np.uint8)
    planes = rng.integers(0, 1 << n_bits, size=(K, N)).astype(np.uint8)
    w_scale = (rng.random(N) + 0.5).astype(np.float32)
    return x, planes, w_scale


def _mask(planes, n_bits, seed):
    """The reference's block mask with some live blocks switched off."""
    K, N = planes.shape
    bk, bn = min(rk.DEFAULT_BK, K), min(rk.DEFAULT_BN, N)
    pk, pn = (-K) % bk, (-N) % bn
    padded = np.pad(planes, ((0, pk), (0, pn)))
    unpacked = np.asarray(rk.unpack_bitplanes_bytes(jnp.asarray(padded), n_bits))
    mask = np.asarray(rk.plane_block_mask(jnp.asarray(unpacked), bk, bn))
    drop = np.random.default_rng(seed).random(mask.shape) < 0.4
    return np.where(drop, 0, mask).astype(np.int8)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_equals_pallas_kernel(case, signed, masked):
    M, K, N, n_bits = case
    x, planes, w_scale = _operands(M, K, N, n_bits, sum(case), signed)
    mask = _mask(planes, n_bits, M) if masked else None
    kw = dict(n_bits=n_bits, signed=signed)
    for out_dtype, jdt in ((torch.int32, jnp.int32), (torch.float32, jnp.float32)):
        want = np.asarray(rk.bitserial_matmul(
            jnp.asarray(x), jnp.asarray(planes), jnp.float32(0.37),
            jnp.asarray(w_scale), None if mask is None else jnp.asarray(mask),
            out_dtype=jdt, interpret=True, **kw))
        got = tk.bitserial_matmul_plain(
            torch.from_numpy(x), torch.from_numpy(planes), 0.37,
            torch.from_numpy(w_scale),
            None if mask is None else torch.from_numpy(mask),
            out_dtype=out_dtype, **kw)
        # the wrapper takes the plain version for CPU tensors
        via_wrapper = tk.bitserial_matmul(
            torch.from_numpy(x), torch.from_numpy(planes), 0.37,
            torch.from_numpy(w_scale),
            None if mask is None else torch.from_numpy(mask),
            out_dtype=out_dtype, **kw)
        assert got.dtype == out_dtype
        assert (got.numpy().view(np.int32) == want.view(np.int32)).all()
        assert torch.equal(got, via_wrapper)


@pytest.mark.parametrize("case", CASES[1:], ids=lambda c: "x".join(map(str, c)))
def test_exact_entry_equals_reference_ops(case):
    M, K, N, n_bits = case
    x, planes, _ = _operands(M, K, N, n_bits, M + N, False)
    want = np.asarray(rops.bitserial_matmul_exact(
        jnp.asarray(x, jnp.int32), jnp.asarray(planes), n_bits=n_bits))
    got = tops.bitserial_matmul_exact(torch.from_numpy(x),
                                      torch.from_numpy(planes), n_bits=n_bits)
    assert got.dtype == torch.int32 and (got.numpy() == want).all()
    again = tk.bitserial_matmul_plain(torch.from_numpy(x),
                                      torch.from_numpy(planes), n_bits=n_bits,
                                      out_dtype=torch.int32, signed=False)
    assert torch.equal(got, again)


def test_plane_block_mask_equals_reference():
    x, planes, _ = _operands(4, 600, 300, 8, 1, False)
    planes[256:512] &= 0x0F  # some empty plane blocks
    got = tk.plane_block_mask(torch.from_numpy(planes), 8)
    pad = np.pad(planes, ((0, (-600) % 256), (0, (-300) % 128)))
    want = rk.plane_block_mask(rk.unpack_bitplanes_bytes(jnp.asarray(pad), 8),
                               256, 128)
    assert (got.numpy() == np.asarray(want)).all()


def test_wrapper_rejects_bad_operands():
    x = torch.zeros((4, 8), dtype=torch.uint8)
    planes = torch.zeros((8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="K=8"):
        tk.bitserial_matmul(x, torch.zeros((9, 3), dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8 or int8"):
        tk.bitserial_matmul(x.to(torch.int32), planes)
    with pytest.raises(ValueError, match="n_bits"):
        tk.bitserial_matmul(x, planes, n_bits=9)
    with pytest.raises(ValueError, match="plane_mask"):
        tk.bitserial_matmul(x, planes, plane_mask=torch.ones((8, 2, 2),
                                                            dtype=torch.int8))


def test_failed_build_raises_kernel_error(tmp_path, monkeypatch):
    """A compiler that fails makes ``build`` raise ``KernelError``."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: injected' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(tk.shutil, "which", lambda name: str(nvcc))
    monkeypatch.setattr(tk, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tk, "_LIB", None)
    with pytest.raises(tk.KernelError, match="injected"):
        tk.build()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.fixture
def gpu():
    """Skips (decided at run time, not at collection) without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; kernel is held against its plain "
                    "version by chip_smoke.py")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_kernel_matches_plain_on_gpu(case, gpu):
    M, K, N, n_bits = case
    for signed in (False, True):
        x, planes, w_scale = _operands(M, K, N, n_bits, M, signed)
        args = [torch.from_numpy(a).to(gpu) for a in (x, planes, w_scale)]
        for out_dtype in (torch.int32, torch.float32):
            kw = dict(n_bits=n_bits, signed=signed, out_dtype=out_dtype)
            got = tk.bitserial_matmul(args[0], args[1], 0.37, args[2], **kw)
            want = tk.bitserial_matmul_plain(args[0], args[1], 0.37, args[2],
                                             **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
