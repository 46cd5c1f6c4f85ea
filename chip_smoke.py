"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one CUDA GPU

Phases (any failure exits non-zero; results go to lines before the last):

1. card: ``nvidia-smi`` name and power limit;
2. build: compile ``src/repro_torch/csrc/bitserial_gemm.cu`` and
   ``bitserial_gemm_a4.cu`` with nvcc, one process per source, in parallel;
3. each kernel against its plain torch version on the card: the 8-bit
   kernel at random ragged shapes (n_bits 1..8, signed and unsigned planes,
   with and without the occupancy mask, int32 and float32 epilogues) and at
   the full-width main path's shapes; the W4A4 kernel at random ragged
   shapes (n_bits 1..4, odd and even K, signed and unsigned, masked or not,
   both epilogues) and at the full-width 4-bit shapes.  Bit-equal: both
   compute ``(f32(acc) * x_scale) * w_scale`` in that order;
4. full-width Inception v3 (299 px, 1001 classes, seeded random weights)
   served by ``NCServingEngine(max_batch=2)``: 4 requests, finite logits,
   each byte-identical to a standalone ``nc_forward`` of its image, the
   ``gemm`` backend native with 0 delegations and the kernel launched;
5. the 4-bit path at full width: ``nc_conv2d`` with 4-bit QuantParams at
   three full-width conv layers' shapes (batch 2) and ``nc_fc`` at
   2048 -> 1001, through the ``gemm`` backend; the W4A4 kernel launched and
   the 8-bit kernel not; outputs, cycles and ``ConvStats`` byte-identical
   with the W4A4 route swapped for its plain version;
6. full-width integrity and compressed: one checked, compressed batch-2
   ``nc_forward`` without faults (logits equal phase 4's), then
   ``NCServingEngine(integrity=True, compressed=True)`` inside
   ``faults.inject(seed=7,filter=0.05,act=0.01,compute=0.01,stuck=3)`` on 2
   of phase 4's images: none failed or degraded, logits byte-identical to
   phase 4's, ``detected == corrupt_attempts`` with faults injected; prints
   the fault ledger, the checksum and re-execution cycles, the CSR bytes
   and the wall time;
7. one batch-2 full-width forward with the kernel and one with the plain
   version: logits and every layer report byte-identical; the correlation
   with the float forward is printed for information;
8. times on the card: each kernel, its plain version and one
   ``torch.matmul`` on float64 copies of the (unpacked) operands at its
   shapes; the full-width forward and its split into pack / dot / min-max
   tree / requant;
9. one JSON line listing the kernels, then the card line, then
   ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
H100_INT8_OPS_S = 1979e12  # dense int8 tensor-core rate, H100 SXM data sheet
B = 2  # main-path batch of the timed and compared forwards
# (name, M, K, N) of the main path's GEMMs at batch B (full width); the
# 4-bit path runs the W4A4 kernel at the same shapes
MAIN_SHAPES = [("Conv2d_2b_3x3", B * 21609, 288, 64),
               ("Conv2d_4a_3x3", B * 5041, 720, 192),
               ("Mixed_6a_b0_0", B * 289, 2592, 384),
               ("FullyConnected", B, 2048, 1001)]
# the three conv layers' input sides, channels, filter size, filters,
# stride and padding (inception.FULL) behind MAIN_SHAPES
CONV_LAYERS = [("Conv2d_2b_3x3", 147, 32, 3, 64, 1, "SAME"),
               ("Conv2d_4a_3x3", 73, 80, 3, 192, 1, "VALID"),
               ("Mixed_6a_b0_0", 35, 288, 3, 384, 2, "VALID")]
FAULT_PROFILE = "seed=7,filter=0.05,act=0.01,compute=0.01,stuck=3"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms (CUDA events around ``reps``)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel(bsm, dev) -> float:
    """Kernel against plain at random and main-path shapes; returns the
    largest absolute difference (launches here are not main-path counts)."""
    g = torch.Generator().manual_seed(1)
    worst = 0.0
    cases = []
    for i, (M, K, N) in enumerate([(1, 1, 1), (7, 33, 5), (65, 31, 129),
                                   (130, 257, 67), (64, 64, 64),
                                   (3, 600, 200), (257, 1000, 130),
                                   (100, 520, 300)]):
        n_bits = 1 + i % 8
        for signed in (False, True):
            for masked in (False, True):
                for x_dtype in (torch.uint8, torch.int8):
                    cases.append((M, K, N, n_bits, signed, masked, x_dtype))
    for M, K, N, n_bits, signed, masked, x_dtype in cases:
        x = torch.randint(0, 256, (M, K), generator=g, dtype=torch.int64)
        x = x.to(torch.uint8).view(x_dtype).to(dev)
        planes = torch.randint(0, 1 << n_bits, (K, N), generator=g,
                               dtype=torch.int64).to(torch.uint8).to(dev)
        w_scale = (torch.rand(N, generator=g) + 0.5).to(dev)
        mask = None
        if masked:
            full = bsm.plane_block_mask(planes, n_bits, 48, 80)
            drop = torch.rand(full.shape, generator=g) < 0.3
            mask = torch.where(drop.to(dev), torch.zeros_like(full), full)
        kw = dict(n_bits=n_bits, signed=signed, block_k=48, block_n=80)
        for out_dtype in (torch.int32, torch.float32):
            got = bsm.bitserial_matmul(x, planes, 0.37, w_scale, mask,
                                       out_dtype=out_dtype, **kw)
            want = bsm.bitserial_matmul_plain(x, planes, 0.37, w_scale, mask,
                                              out_dtype=out_dtype, **kw)
            torch.cuda.synchronize()
            if not bits_equal(got, want):
                raise AssertionError(
                    f"kernel != plain at M,K,N={M, K, N} n_bits={n_bits} "
                    f"signed={signed} mask={masked} x={x_dtype} "
                    f"out={out_dtype}: max diff "
                    f"{(got.double() - want.double()).abs().max().item()}")
            worst = max(worst, (got.double() - want.double()).abs().max().item())
    log(f"[kernel] {len(cases) * 2} random cases equal to the plain version")
    for name, M, K, N in MAIN_SHAPES:
        x = torch.randint(0, 256, (M, K), generator=g).to(torch.uint8).to(dev)
        planes = torch.randint(0, 256, (K, N), generator=g).to(torch.uint8).to(dev)
        got = bsm.bitserial_matmul(x, planes, n_bits=8, out_dtype=torch.int32,
                                   signed=False)
        want = bsm.bitserial_matmul_plain(x, planes, n_bits=8,
                                          out_dtype=torch.int32, signed=False)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"kernel != plain at {name} {M}x{K}x{N}")
        log(f"[kernel] {name} {M}x{K}x{N}: int32 equal to the plain version")
    return worst


def phase_kernel_a4(bsm, dev) -> float:
    """The W4A4 kernel against its plain version at random and full-width
    4-bit shapes; returns the largest absolute difference."""
    g = torch.Generator().manual_seed(3)
    worst = 0.0
    cases = []
    for i, (M, K, N) in enumerate([(1, 1, 1), (7, 33, 5), (65, 31, 129),
                                   (130, 257, 67), (64, 64, 64),
                                   (3, 600, 200), (257, 1001, 130),
                                   (100, 520, 300)]):
        n_bits = 1 + i % 4
        for signed in (False, True):
            for masked in (False, True):
                cases.append((M, K, N, n_bits, signed, masked))
    for M, K, N, n_bits, signed, masked in cases:
        xp = torch.randint(0, 256, (M, (K + 1) // 2), generator=g)
        xp = xp.to(torch.uint8).to(dev)
        planes = torch.randint(0, 1 << n_bits, (K, N), generator=g,
                               dtype=torch.int64).to(torch.uint8).to(dev)
        w_scale = (torch.rand(N, generator=g) + 0.5).to(dev)
        mask = None
        if masked:
            full = bsm.plane_block_mask(planes, n_bits, 48, 80)
            drop = torch.rand(full.shape, generator=g) < 0.3
            mask = torch.where(drop.to(dev), torch.zeros_like(full), full)
        kw = dict(n_bits=n_bits, signed=signed, block_k2=24, block_n=80)
        for out_dtype in (torch.int32, torch.float32):
            got = bsm.bitserial_matmul_a4(xp, planes, 0.37, w_scale, mask,
                                          out_dtype=out_dtype, **kw)
            want = bsm.bitserial_matmul_a4_plain(xp, planes, 0.37, w_scale,
                                                 mask, out_dtype=out_dtype,
                                                 **kw)
            torch.cuda.synchronize()
            diff = (got.double() - want.double()).abs().max().item()
            if not bits_equal(got, want):
                raise AssertionError(
                    f"a4 kernel != plain at M,K,N={M, K, N} n_bits={n_bits} "
                    f"signed={signed} mask={masked} out={out_dtype}: max "
                    f"diff {diff}")
            worst = max(worst, diff)
    log(f"[kernel-a4] {len(cases) * 2} random cases equal to the plain "
        f"version")
    for name, M, K, N in MAIN_SHAPES:
        xp = torch.randint(0, 256, (M, (K + 1) // 2), generator=g)
        xp = xp.to(torch.uint8).to(dev)
        planes = torch.randint(0, 16, (K, N), generator=g).to(torch.uint8).to(dev)
        kw = dict(n_bits=4, out_dtype=torch.int32, signed=False)
        got = bsm.bitserial_matmul_a4(xp, planes, **kw)
        want = bsm.bitserial_matmul_a4_plain(xp, planes, **kw)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"a4 kernel != plain at {name} {M}x{K}x{N}")
        log(f"[kernel-a4] {name} {M}x{K}x{N}: int32 equal to the plain "
            f"version")
    return worst


def phase_serve(inception, serve, backends, bsm, params, images, dev, cfg):
    engine = serve.NCServingEngine(params, cfg, max_batch=2, device=dev)
    for i, img in enumerate(images):
        engine.submit(serve.NCRequest(rid=i, image=img))
    bsm.bitserial_matmul.launches = 0
    backends.dispatch_stats_clear()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bsm.bitserial_matmul.launches
    gemm = backends.dispatch_stats()["gemm"]
    log(f"[serve] {len(done)} full-width requests in {wall:.2f} s "
        f"(batches {engine.stats()['batch_histogram']}); gemm dispatch "
        f"{gemm}; kernel launches {launches}")
    if len(done) != len(images) or engine.failed:
        raise AssertionError(f"served {len(done)} of {len(images)}: "
                             f"{engine.errors}")
    if any(r.degraded for r in done):
        raise AssertionError("a batch left the emulation (degraded)")
    if gemm["native"] == 0 or gemm["fallback"] != 0:
        raise AssertionError(f"gemm backend dispatch {gemm}")
    if launches == 0:
        raise AssertionError("the kernel was not launched on the main path")
    for r in done:
        if r.logits.shape != (cfg.classes,) or not bool(torch.isfinite(r.logits).all()):
            raise AssertionError(f"request {r.rid}: bad logits")
        alone, _ = inception.nc_forward(params, images[r.rid], config=cfg,
                                        device=dev)
        if not bits_equal(r.logits, alone):
            raise AssertionError(f"request {r.rid}: served logits differ "
                                 f"from a standalone nc_forward")
    log("[serve] every request's logits byte-identical to standalone "
        "nc_forward")
    return launches, wall, {r.rid: r.logits for r in done}


def _exact_plain(bsm):
    """``ops.bitserial_matmul_exact`` with both kernels swapped for their
    plain versions (the gemm backend reaches the kernels through it)."""
    def exact(x_q, planes, *, n_bits, w4a4=False):
        fn = (bsm.bitserial_matmul_a4_plain if w4a4
              else bsm.bitserial_matmul_plain)
        return fn(x_q, planes, 1.0, None, n_bits=n_bits,
                  out_dtype=torch.int32, signed=False)
    return exact


def _four_bit_calls(nc_layers, qmod, dev):
    """The 4-bit path at full width: ``nc_conv2d`` at CONV_LAYERS (batch B)
    and ``nc_fc`` at 2048 -> 1001 with 4-bit operands and QuantParams built
    as the reference's backend conformance suite builds them.  Returns each
    call's (output, cycles, stats)."""
    g = torch.Generator().manual_seed(4)
    x_qp = qmod.QuantParams(scale=float(np.float32(1 / 16)), zero_point=1,
                            bits=4)
    w_qp = qmod.QuantParams(scale=float(np.float32(0.05)), zero_point=8,
                            bits=4)
    outs = []
    for name, H, C, R, M, stride, pad in CONV_LAYERS:
        x = torch.randint(0, 16, (B, H, H, C), generator=g).to(torch.uint8)
        w = torch.randint(0, 16, (R, R, C, M), generator=g).to(torch.uint8)
        outs.append(nc_layers.nc_conv2d(
            x.to(dev), w.to(dev), [x_qp] * B, w_qp, stride, padding=pad,
            engine="gemm", return_stats=True))
    x = torch.randint(0, 16, (B, 2048), generator=g).to(torch.uint8)
    w = torch.randint(0, 16, (2048, 1001), generator=g).to(torch.uint8)
    outs.append(nc_layers.nc_fc(x.to(dev), w.to(dev), [x_qp] * B, w_qp,
                                engine="gemm", return_stats=True))
    torch.cuda.synchronize()
    return outs


def phase_four_bit(nc_layers, qmod, ops, backends, bsm, dev):
    """The 4-bit path through the W4A4 kernel; returns its launch count."""
    bsm.bitserial_matmul.launches = 0
    bsm.bitserial_matmul_a4.launches = 0
    backends.dispatch_stats_clear()
    t0 = time.perf_counter()
    outs = _four_bit_calls(nc_layers, qmod, dev)
    wall = time.perf_counter() - t0
    launches = bsm.bitserial_matmul_a4.launches
    launches8 = bsm.bitserial_matmul.launches
    gemm = backends.dispatch_stats()["gemm"]
    log(f"[4-bit] 3 full-width convs + FC at batch {B} in {wall:.2f} s; "
        f"gemm dispatch {gemm}; a4 kernel launches {launches}, 8-bit "
        f"kernel launches {launches8}")
    if gemm["native"] == 0 or gemm["fallback"] != 0:
        raise AssertionError(f"gemm backend dispatch {gemm}")
    if launches == 0 or launches8 != 0:
        raise AssertionError("the 4-bit path did not run the W4A4 kernel "
                             "alone")
    real = ops.bitserial_matmul_exact
    ops.bitserial_matmul_exact = _exact_plain(bsm)
    before = bsm.bitserial_matmul_a4.launches
    try:
        plain = _four_bit_calls(nc_layers, qmod, dev)
    finally:
        ops.bitserial_matmul_exact = real
    if bsm.bitserial_matmul_a4.launches != before:
        raise AssertionError("the plain 4-bit run launched the kernel")
    names = [c[0] for c in CONV_LAYERS] + ["FullyConnected"]
    for name, (o, c, st), (po, pc, pst), (_, M, K, N) in zip(
            names, outs, plain, MAIN_SHAPES):
        if not bits_equal(o, po) or c != pc or st != pst:
            raise AssertionError(f"4-bit {name}: kernel != plain")
        if st.lanes != M * K * N:
            raise AssertionError(f"4-bit {name}: {st.lanes} lanes, want "
                                 f"{M}x{K}x{N}")
    log("[4-bit] outputs, cycles and ConvStats byte-identical to the plain "
        "W4A4 route")
    return launches


def phase_faulted_serve(inception, serve, faults, nc_layers, backends, bsm,
                        params, images, clean, dev, cfg):
    """Full-width checked, compressed serving under an active fault
    profile; returns (wall, re-executed passes)."""
    sums = dict(verify_passes=0, reexec_passes=0, faults_detected=0,
                integrity_cycles=0, reexec_cycles=0, csr_payload_bytes=0,
                csr_index_bytes=0)
    real = nc_layers.nc_conv2d

    def counted(*a, **k):
        res = real(*a, **k)
        if k.get("return_stats"):
            for key in sums:
                sums[key] += getattr(res[2], key)
        return res

    engine = serve.NCServingEngine(params, cfg, max_batch=2, integrity=True,
                                   compressed=True, device=dev)
    # the checked, compressed forward with no fault scope: every pass
    # verified, none re-run (the cost of checking alone)
    x = torch.from_numpy(np.stack(images)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = inception.nc_forward(params, x, config=cfg,
                                     wpack=engine.wpack, integrity=True,
                                     compressed=True, device=dev)
    torch.cuda.synchronize()
    checked_wall = time.perf_counter() - t0
    for i in range(len(images)):
        if not bits_equal(logits[i], clean[i]):
            raise AssertionError(f"image {i}: checked, compressed logits "
                                 f"differ from the clean run's")
    log(f"[faults] checked, compressed batch-{len(images)} nc_forward "
        f"without faults: {checked_wall:.2f} s, logits byte-identical to "
        f"the clean run's")
    for i, img in enumerate(images):
        engine.submit(serve.NCRequest(rid=i, image=img))
    nc_layers.nc_conv2d = counted
    bsm.bitserial_matmul.launches = 0
    bsm.bitserial_matmul_a4.launches = 0
    backends.dispatch_stats_clear()
    try:
        with faults.inject(faults.FaultProfile.parse(FAULT_PROFILE)) as fs:
            t0 = time.perf_counter()
            done = engine.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        nc_layers.nc_conv2d = real
    fst = fs.stats()
    log(f"[faults] {len(done)} full-width requests, integrity + compressed, "
        f"under {FAULT_PROFILE} in {wall:.2f} s; gemm dispatch "
        f"{backends.dispatch_stats()['gemm']}; kernel launches "
        f"{bsm.bitserial_matmul.launches}")
    log(f"[faults] ledger: {fst}")
    log(f"[faults] verify passes {sums['verify_passes']}, re-executed passes "
        f"{sums['reexec_passes']}, detected {sums['faults_detected']}; "
        f"checksum cycles {sums['integrity_cycles']}, re-execution cycles "
        f"{sums['reexec_cycles']}; CSR payload {sums['csr_payload_bytes']} B,"
        f" index {sums['csr_index_bytes']} B; engine stats "
        f"failed={engine.stats()['failed']} "
        f"degraded={engine.stats()['degraded_batches']} "
        f"retries={engine.stats()['retries']}")
    if len(done) != len(images) or engine.failed or engine.queue:
        raise AssertionError(f"served {len(done)} of {len(images)}: "
                             f"{engine.errors}")
    if any(r.degraded for r in done):
        raise AssertionError("a faulted batch left the emulation (degraded)")
    if fst["injected"] == 0 or fst["detected"] != fst["corrupt_attempts"]:
        raise AssertionError(f"fault ledger {fst}: silent corruption or "
                             f"nothing injected")
    if not fst["quarantined_slices"]:
        raise AssertionError("the stuck slice was never quarantined")
    if bsm.bitserial_matmul.launches == 0:
        raise AssertionError("the checked path did not launch the kernel")
    for r in done:
        if not bits_equal(r.logits, clean[r.rid]):
            raise AssertionError(f"request {r.rid}: faulted logits differ "
                                 f"from the clean run's")
    log("[faults] every request's logits byte-identical to the clean "
        "serving run; detected == corrupt_attempts")
    return wall, sums["reexec_passes"]


def phase_plain_forward(inception, ops, bsm, params, x, dev, cfg):
    wpack = inception.prepare_conv_weights(params, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lk, rk = inception.nc_forward(params, x, config=cfg, wpack=wpack,
                                  device=dev)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    saved = ops.bitserial_matmul_exact
    ops.bitserial_matmul_exact = _exact_plain(bsm)
    launches = bsm.bitserial_matmul.launches
    try:
        t0 = time.perf_counter()
        lp, rp = inception.nc_forward(params, x, config=cfg, wpack=wpack,
                                      device=dev)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        ops.bitserial_matmul_exact = saved
    if bsm.bitserial_matmul.launches != launches:
        raise AssertionError("the plain forward launched the kernel")
    if not bits_equal(lk, lp):
        raise AssertionError("full-width logits: kernel != plain")
    if rk != rp:
        raise AssertionError("full-width layer reports: kernel != plain")
    if lk.shape != (x.shape[0], cfg.classes) or not bool(torch.isfinite(lk).all()):
        raise AssertionError("full-width logits not finite")
    ref = inception.apply(params, x, config=cfg)
    corr = np.corrcoef(lk.double().cpu().numpy().ravel(),
                       ref.double().cpu().numpy().ravel())[0, 1]
    log(f"[forward] batch {x.shape[0]} full width: kernel {t_kernel:.2f} s, "
        f"plain {t_plain:.2f} s; logits and {len(rk.layers)} layer reports "
        f"byte-identical; corr(emulated, float) = {corr:.4f} (information)")
    return t_kernel, wpack


def phase_split(inception, nc_layers, bitserial, params, x, wpack, dev, cfg):
    """Full-width forward with a synchronizing wall-clock timer around each
    stage (the synchronizations inflate the total slightly)."""
    split = {"pack": 0.0, "dot": 0.0, "minmax tree": 0.0, "requant": 0.0}

    def timed(stage, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            split[stage] += time.perf_counter() - t
            return out
        return wrapper

    patches = [(nc_layers, "_pack_x_rows", "pack"),
               (nc_layers, "_pack_w_rows", "pack"),
               (bitserial, "packed_dot_words", "dot"),
               (nc_layers, "nc_minmax", "minmax tree"),
               (inception, "_requant_image", "requant")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, stage in patches:
        setattr(mod, attr, timed(stage, getattr(mod, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inception.nc_forward(params, x, config=cfg, wpack=wpack, device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    split["other"] = total - sum(split.values())
    log(f"[split] batch {x.shape[0]} full-width forward {total:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))
    return split


def phase_times(bsm, dev):
    g = torch.Generator().manual_seed(2)
    rows = []
    for name, M, K, N in MAIN_SHAPES:
        x = torch.randint(0, 256, (M, K), generator=g).to(torch.uint8).to(dev)
        planes = torch.randint(0, 256, (K, N), generator=g).to(torch.uint8).to(dev)
        kw = dict(n_bits=8, out_dtype=torch.int32, signed=False)
        ms = cuda_ms(lambda: bsm.bitserial_matmul(x, planes, **kw))
        plain_ms = cuda_ms(lambda: bsm.bitserial_matmul_plain(x, planes, **kw),
                           reps=3, warmup=1)
        xf, wf = x.double(), planes.double()
        lib_ms = cuda_ms(lambda: torch.matmul(xf, wf))
        if not torch.equal(torch.matmul(xf, wf).to(torch.int64),
                           bsm.bitserial_matmul(x, planes, **kw).to(torch.int64)):
            raise AssertionError(f"torch.matmul yardstick disagrees at {name}")
        # the function is one 8-bit GEMM: the plane weights fold into the
        # decoded weights before a single product (as torch.matmul shows)
        nbytes = M * K + K * N + 4 * M * N
        ops = 2 * M * N * K
        bytes_ms = nbytes / H100_HBM_BYTES_S * 1e3
        ops_ms = ops / H100_INT8_OPS_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms > ops_ms else "operations"
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bytes_ms=bytes_ms, ops_ms=ops_ms))
        log(f"[time] {name} {M}x{K}x{N}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.matmul f64 {lib_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
    return rows


def phase_times_a4(bsm, dev):
    g = torch.Generator().manual_seed(5)
    rows = []
    for name, M, K, N in MAIN_SHAPES:
        xp = torch.randint(0, 256, (M, (K + 1) // 2), generator=g)
        xp = xp.to(torch.uint8).to(dev)
        planes = torch.randint(0, 16, (K, N), generator=g).to(torch.uint8).to(dev)
        kw = dict(n_bits=4, out_dtype=torch.int32, signed=False)
        ms = cuda_ms(lambda: bsm.bitserial_matmul_a4(xp, planes, **kw))
        plain_ms = cuda_ms(
            lambda: bsm.bitserial_matmul_a4_plain(xp, planes, **kw),
            reps=3, warmup=1)
        b = xp.to(torch.int64)
        xf = torch.stack([b & 0xF, b >> 4], dim=-1).reshape(M, -1)[:, :K]
        xf, wf = xf.double().contiguous(), planes.double()
        lib_ms = cuda_ms(lambda: torch.matmul(xf, wf))
        if not torch.equal(torch.matmul(xf, wf).to(torch.int64),
                           bsm.bitserial_matmul_a4(xp, planes, **kw)
                           .to(torch.int64)):
            raise AssertionError(f"torch.matmul yardstick disagrees at {name}")
        # one GEMM of 2*M*N*K operations (no 4-bit tensor-core path faster
        # than int8 on Hopper); bytes: nibble-packed x, weight bytes, int32 out
        nbytes = M * ((K + 1) // 2) + K * N + 4 * M * N
        ops = 2 * M * N * K
        bytes_ms = nbytes / H100_HBM_BYTES_S * 1e3
        ops_ms = ops / H100_INT8_OPS_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms > ops_ms else "operations"
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bytes_ms=bytes_ms, ops_ms=ops_ms))
        log(f"[time-a4] {name} {M}x{K}x{N}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.matmul f64 {lib_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
    return rows


def _kernel_entry(name, source, replaces, launches, worst, rows):
    """One entry of the kernels line; times and bound summed over the
    four shapes of MAIN_SHAPES."""
    total = {k: sum(r[k] for r in rows) for k in
             ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
              "ops_ms")}
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": worst,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if total["bytes_ms"] > total["ops_ms"]
                     else "operations"),
        "library_ms": total["library_ms"],
    }


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 2
    from repro_torch.core import backends, bitserial, faults, nc_layers
    from repro_torch.core import quantize
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import inception

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    t0 = time.perf_counter()
    bsm.build_all()
    log(f"[build] bitserial_gemm and bitserial_gemm_a4 built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("bitserial_gemm", "bitserial_gemm_a4"):
        for line in bsm.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    worst = phase_kernel(bsm, dev)
    worst_a4 = phase_kernel_a4(bsm, dev)
    cfg = inception.FULL
    params = inception.init_params(torch.Generator().manual_seed(0),
                                   config=cfg, device=dev)
    rng = np.random.default_rng(0)
    images = [rng.random((cfg.img, cfg.img, 3), dtype=np.float32)
              for _ in range(4)]
    launches, _, served = phase_serve(inception, serve, backends, bsm,
                                      params, images, dev, cfg)
    launches_a4 = phase_four_bit(nc_layers, quantize, ops, backends, bsm, dev)
    faulted_wall, reexec = phase_faulted_serve(
        inception, serve, faults, nc_layers, backends, bsm, params,
        images[:B], served, dev, cfg)
    x = torch.from_numpy(np.stack(images[:B])).to(dev)
    t_forward, wpack = phase_plain_forward(inception, ops, bsm, params, x,
                                           dev, cfg)
    log(f"[faults] checked, compressed, faulted batch-{B} serving "
        f"{faulted_wall:.2f} s against the clean batch-{B} forward "
        f"{t_forward:.2f} s ({reexec} passes re-run)")
    phase_split(inception, nc_layers, bitserial, params, x, wpack, dev, cfg)
    rows = phase_times(bsm, dev)
    rows_a4 = phase_times_a4(bsm, dev)
    kernels = [
        _kernel_entry("bitserial_matmul",
                      "src/repro_torch/csrc/bitserial_gemm.cu",
                      "src/repro/kernels/bitserial_matmul.py:148",
                      launches, worst, rows),
        _kernel_entry("bitserial_matmul_a4",
                      "src/repro_torch/csrc/bitserial_gemm_a4.cu",
                      "src/repro/kernels/bitserial_matmul.py:219",
                      launches_a4, worst_a4, rows_a4),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
