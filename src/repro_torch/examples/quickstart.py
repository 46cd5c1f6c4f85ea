"""Quickstart on the port: the paper's pipeline end to end.

1. bit-exact in-SRAM arithmetic (add / multiply / reduce) with the
   paper's cycle counts, through ``repro_torch.core.bitserial``,
2. the cycle-accurate Neural Cache simulator reproducing the paper's
   headline numbers for Inception v3 on a 35 MB Xeon LLC,
3. the quantized GEMMs on the card: the W8A8 kernel
   (``kernels.ops.quant_matmul``) and the bit-serial kernel at 8, 4 and 2
   bits (``kernels.ops.pack_weights`` and ``ops.bitserial_matmul``) on a
   128 x 256 x 128 product, each with its relative error.

Run:  python -m repro_torch.examples.quickstart [--device cpu]

On a CUDA device the GEMMs launch the hand-written kernels; on the CPU
they run the kernels' plain versions.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import bitserial as B
from repro_torch.core.cache_geometry import XEON_E5_35MB
from repro_torch.core.quantize import (choose_qparams_symmetric, quantize,
                                       quantize_per_channel)
from repro_torch.core.simulator import simulate_network
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as K
from repro_torch.models.inception import inception_v3_specs

# the paper's measured baselines for Inception v3 (Table IV)
CPU_MS, GPU_MS = 86.4, 36.3
GEMM_BITS = (8, 4, 2)


def demo_bitserial(device=None) -> dict:
    """Add, multiply and an 8-lane reduce of seeded 8-bit operands on
    ``device``; returns each result's exactness and cycles."""
    dev = resolve_device(device)
    print("=== 1. bit-serial in-SRAM arithmetic (paper §III) ===")
    rng = np.random.default_rng(0)
    a_np, b_np = rng.integers(0, 200, 8), rng.integers(0, 55, 8)
    a = torch.as_tensor(a_np, device=dev)
    b = torch.as_tensor(b_np, device=dev)
    ap, bp = B.bitplane_pack(a, 8), B.bitplane_pack(b, 8)
    s, cyc_add = B.bitserial_add(ap, bp)
    p, cyc_mul = B.bitserial_multiply(ap, bp)
    add_ok = np.array_equal(B.bitplane_unpack(s).cpu().numpy(), a_np + b_np)
    mul_ok = np.array_equal(B.bitplane_unpack(p).cpu().numpy(), a_np * b_np)
    print(f"  a+b bit-exact: {add_ok}  ({cyc_add} cycles = n+1)")
    print(f"  a*b bit-exact: {mul_ok}  ({cyc_mul} cycles = n^2+5n-2)")
    r, cyc_red = B.bitserial_reduce(p)
    total = int(B.bitplane_unpack(r)[0])
    want = int((a_np * b_np).sum())
    print(f"  reduce(8 lanes): {total} == {want}  ({cyc_red} cycles)")
    return {"add_exact": add_ok, "add_cycles": cyc_add, "mul_exact": mul_ok,
            "mul_cycles": cyc_mul, "reduce": total, "reduce_want": want,
            "reduce_cycles": cyc_red}


def demo_simulator() -> dict:
    """Full Inception v3 on the 35 MB LLC through the simulator (pure
    Python: the same numbers on every device)."""
    print("\n=== 2. Neural Cache simulator: Inception v3 on 35MB LLC ===")
    res = simulate_network(inception_v3_specs(), XEON_E5_35MB)
    ms = res.latency_s * 1e3
    print(f"  total latency : {ms:8.2f} ms   (paper: 4.72 ms)")
    print(f"  vs CPU 86.4 ms: {CPU_MS / ms:8.1f} x    (paper: 18.3x)")
    print(f"  vs GPU 36.3 ms: {GPU_MS / ms:8.1f} x    (paper: 7.7x)")
    return {"ms": ms, "vs_cpu": CPU_MS / ms, "vs_gpu": GPU_MS / ms}


def _rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y - ref).abs().mean() / ref.abs().mean())


def demo_kernels(x: torch.Tensor, w: torch.Tensor) -> dict:
    """The W8A8 GEMM and the bit-serial GEMM at 8, 4 and 2 bits of
    float32 ``x [M, K]`` times ``w [K, N]`` on their device; returns each
    relative error against ``x @ w`` (``"w8a8"``, ``"bitserial8"``, ...)."""
    print("\n=== 3. The card: quantized GEMM kernels ===")
    ref = x @ w
    qp = choose_qparams_symmetric(x.abs().max())
    xq = quantize(x, qp)
    wq, wscale = quantize_per_channel(w)
    y8 = K.quant_matmul(xq, wq, qp.scale, wscale.reshape(-1))
    errs = {"w8a8": _rel_err(y8, ref)}
    print(f"  W8A8 fused kernel rel.err: {errs['w8a8']:.4f}")
    for bits in GEMM_BITS:
        wqb, wsb = quantize_per_channel(w, bits=bits)
        planes = K.pack_weights(wqb, bits)  # byte-packed
        yb = K.bitserial_matmul(xq, planes, qp.scale, wsb.reshape(-1),
                                n_bits=bits)
        errs[f"bitserial{bits}"] = _rel_err(yb, ref)
        print(f"  bit-serial {bits}-bit ({bits} planes/byte-packed, cost ∝ "
              f"planes) rel.err: {errs[f'bitserial{bits}']:.4f}")
    return errs


def gemm_operands(generator: torch.Generator, device=None):
    """The seeded 128 x 256 and 256 x 128 float32 operands (``w`` scaled by
    0.2, as the reference draws them), drawn on the CPU and moved to
    ``device``."""
    dev = resolve_device(device)
    x = torch.randn((128, 256), generator=generator)
    w = torch.randn((256, 128), generator=generator) * 0.2
    return x.to(dev), w.to(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    demo_bitserial(dev)
    demo_simulator()
    x, w = gemm_operands(torch.Generator().manual_seed(7), dev)
    demo_kernels(x, w)
    if dev.type == "cuda":
        from repro_torch.kernels import bitserial_matmul, quant_matmul
        print(f"  kernel launches: quant_matmul "
              f"{quant_matmul.quant_matmul.launches}, bitserial_matmul "
              f"{bitserial_matmul.bitserial_matmul.launches}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
