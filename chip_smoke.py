"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one CUDA GPU

Phases (any failure exits non-zero; results go to lines before the last):

1. card: ``nvidia-smi`` name and power limit;
2. build: compile ``src/repro_torch/csrc/bitserial_gemm.cu`` with nvcc;
3. the bit-serial GEMM kernel against its plain torch version on the card,
   at random ragged shapes (n_bits 1..8, signed and unsigned planes, with
   and without the occupancy mask, int32 and float32 epilogues) and at the
   full-width main path's shapes (int32 equal; the float epilogue must be
   equal too, since both compute ``(f32(acc) * x_scale) * w_scale`` in that
   order with round-to-nearest);
4. full-width Inception v3 (299 px, 1001 classes, seeded random weights)
   served by ``NCServingEngine(max_batch=2)``: 4 requests, finite logits,
   each byte-identical to a standalone ``nc_forward`` of its image, the
   ``gemm`` backend native with 0 delegations and the kernel launched;
5. one batch-2 full-width forward with the kernel and one with the plain
   version: logits and every layer report byte-identical; the correlation
   with the float forward is printed for information;
6. times on the card: the kernel, the plain version and one ``torch.matmul``
   on float64 copies at the main path's shapes; the full-width forward and
   its split into pack / dot / min-max tree / requant;
7. one JSON line listing the kernels, then the card line, then
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
# (name, M, K, N) of the main path's GEMMs at batch B (full width)
MAIN_SHAPES = [("Conv2d_2b_3x3", B * 21609, 288, 64),
               ("Conv2d_4a_3x3", B * 5041, 720, 192),
               ("Mixed_6a_b0_0", B * 289, 2592, 384),
               ("FullyConnected", B, 2048, 1001)]


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
    return launches, wall


def phase_plain_forward(inception, ops, bsm, params, x, dev, cfg):
    wpack = inception.prepare_conv_weights(params, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lk, rk = inception.nc_forward(params, x, config=cfg, wpack=wpack,
                                  device=dev)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0

    def exact_plain(x_q, planes, *, n_bits):
        return bsm.bitserial_matmul_plain(x_q, planes, 1.0, None,
                                          n_bits=n_bits,
                                          out_dtype=torch.int32, signed=False)

    # the gemm backend reaches the kernel through ops.bitserial_matmul_exact
    saved = ops.bitserial_matmul_exact
    ops.bitserial_matmul_exact = exact_plain
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


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 2
    from repro_torch.core import backends, bitserial, nc_layers
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import inception

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    t0 = time.perf_counter()
    bsm.build()
    log(f"[build] bitserial_gemm built in {time.perf_counter() - t0:.1f} s")
    for line in bsm.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    worst = phase_kernel(bsm, dev)
    cfg = inception.FULL
    params = inception.init_params(torch.Generator().manual_seed(0),
                                   config=cfg, device=dev)
    rng = np.random.default_rng(0)
    images = [rng.random((cfg.img, cfg.img, 3), dtype=np.float32)
              for _ in range(4)]
    launches, _ = phase_serve(inception, serve, backends, bsm, params,
                              images, dev, cfg)
    x = torch.from_numpy(np.stack(images[:B])).to(dev)
    _, wpack = phase_plain_forward(inception, ops, bsm, params, x, dev, cfg)
    phase_split(inception, nc_layers, bitserial, params, x, wpack, dev, cfg)
    rows = phase_times(bsm, dev)
    total = {k: sum(r[k] for r in rows) for k in
             ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
              "ops_ms")}
    kernels = [{
        "name": "bitserial_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/bitserial_gemm.cu",
        "replaces": "src/repro/kernels/bitserial_matmul.py:148",
        "launches": launches,
        "max_abs_err": worst,
        # times and bound summed over the four main-path shapes (MAIN_SHAPES)
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if total["bytes_ms"] > total["ops_ms"]
                     else "operations"),
        "library_ms": total["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
