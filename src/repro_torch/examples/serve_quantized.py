"""Serve a quantized LM with continuous batching, or quantized Inception
images through the SLO-aware Neural Cache engine, on the port.

The LM demo serves a reduced qwen2-7b (4 layers, d_model 128, d_ff 256,
vocab 512, head_dim 32, float32) with fp32 weights and with W8 and W4
weights dequantized once (:func:`dequantize_tree`), prints each run's
tokens, tok/s and engine steps, and the quantized runs' greedy agreement
with fp32.  On a CUDA device each 24-token prefill runs the flash-attention
kernel.

With ``--neural-cache`` the demo serves images of the reference's reduced
Inception (47 px, width / 8, 8 classes, the stem and the Mixed_5 blocks)
through :class:`~repro_torch.launch.serve.NCServingEngine` (``max_batch=4``
under ``--slo-ms``): the admitted batch histogram, the SLO and calibration
line, the compressed/residency line and the fault ledger are printed, and
request 0's logits are asserted byte-identical to a standalone
``nc_forward``.  On a CUDA device every layer's GEMM runs the bit-serial
kernel through the ``gemm`` backend.

Run:  python -m repro_torch.examples.serve_quantized [--device cpu]
      python -m repro_torch.examples.serve_quantized --neural-cache --slo-ms 5000
      python -m repro_torch.examples.serve_quantized --neural-cache \
          --fault-profile seed=7,filter=0.1,compute=0.05 --compressed --warmup-replan
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import faults
from repro_torch.device import resolve_device
from repro_torch.launch.serve import (NCRequest, NCServingEngine, Request,
                                      ServingEngine)
from repro_torch.models import inception
from repro_torch.models import transformer as T
from repro_torch.quant import quantize_lm_params

NC_CONFIG = dict(img=47, width_div=8, classes=8, stages=("a",))
LM_PROMPTS, LM_PROMPT_LEN, LM_MAX_TOKENS = 8, 24, 8


def _is_quantized(x) -> bool:
    return isinstance(x, dict) and "q" in x


def dequantize_tree(qparams):
    """Weight-only quantization: materialize float32 weights from int8 and
    their scales (serving frameworks do this per layer on the fly; here
    once).  A 1-D scale ``[N]`` broadcasts as ``[1, N]``."""

    def leaf(x):
        if _is_quantized(x):
            scale = x["scale"]
            if scale.ndim == 1:
                scale = scale[None, :]
            return x["q"].to(torch.float32) * scale
        return x

    return tree.map(leaf, qparams, is_leaf=_is_quantized)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Neural Cache serving
# ---------------------------------------------------------------------------
def nc_config():
    """The reference example's reduced Inception."""
    return inception.reduced_config(**NC_CONFIG)


def nc_images(cfg, requests: int) -> np.ndarray:
    """The reference example's images: numpy-seeded, so equal in both
    packages."""
    rng = np.random.default_rng(0)
    return rng.random((requests, cfg.img, cfg.img, 3)).astype(np.float32)


def main_neural_cache(params, cfg, images, slo_ms: float,
                      fault_profile: str | None = None,
                      compressed: bool = False, warmup_replan: bool = False,
                      device=None) -> dict:
    """SLO-aware Neural Cache serving of ``images`` with ``params`` (on
    ``device``) through an engine armed with ``slo_ms``.

    ``fault_profile`` (e.g. ``seed=7,filter=0.1,compute=0.05``) scopes
    seeded fault injection over the run with integrity checking armed;
    ``compressed`` plans from the CSR bit-plane filter store and
    ``warmup_replan`` re-plans after the first batch.  Request 0's logits
    are asserted byte-identical to a standalone ``nc_forward``: the knobs
    change batches and accounting, never results.  Returns the served
    requests (``done``), the engine's ``stats``, the fault scope's
    (``faults``, None without a profile) and the wall (``wall_s``)."""
    dev = resolve_device(device)
    profile = (faults.FaultProfile.parse(fault_profile)
               if fault_profile else None)
    eng = NCServingEngine(params, cfg, max_batch=4, slo_ms=slo_ms,
                          integrity=profile is not None,
                          compressed=compressed, warmup_replan=warmup_replan,
                          device=dev)
    for r in range(len(images)):
        eng.submit(NCRequest(rid=r, image=images[r]))
    scope = (faults.inject(profile) if profile is not None
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    with scope as fs:
        done = eng.run()
    _sync(dev)
    dt = time.perf_counter() - t0
    s = eng.stats()
    print(f"[serve-nc] {len(done)} images in {dt:.2f}s emulated, "
          f"{eng.steps} admitted batches {s['batch_histogram']} "
          f"(stream limit {s['stream_batch_limit']})")
    print(f"[serve-nc] SLO {slo_ms:.0f} ms: {s['slo_hits']} hit / "
          f"{s['slo_misses']} miss (rate "
          f"{s['slo_hit_rate']:.0%}); latency model calibrated x"
          f"{s['calibration_scale']:.0f} wall/modeled over "
          f"{s['calibration_samples']} batches")
    if compressed or warmup_replan:
        print(f"[serve-nc] compressed={s['compressed']} residency credit "
              f"{s['residency_credit_bytes']} B/batch, "
              f"{s['warmup_replans']} warmup re-plan(s)")
    fstats = None
    if profile is not None:
        fstats = fs.stats()
        print(f"[serve-nc] faults (seed {fstats['seed']}): "
              f"{fstats['injected']} injected, {fstats['detected']} "
              f"detected / {fstats['corrupt_attempts']} corrupt passes, "
              f"{fstats['reexecuted']} re-executed; {s['retries']} batch "
              f"retries, {s['degraded_batches']} degraded, "
              f"{s['failed']} failed")
    r0 = next(r for r in done if r.rid == 0)
    ref, _ = inception.nc_forward(params, images[0], config=cfg, device=dev)
    if not torch.equal(r0.logits.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("request 0's served logits differ from a "
                             "standalone nc_forward")
    print("[serve-nc] logits bit-identical to standalone nc_forward — OK")
    return {"done": done, "stats": s, "faults": fstats, "wall_s": dt}


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------
def lm_config():
    """The reference example's reduced qwen2-7b (float32)."""
    return reduced_config(get_config("qwen2-7b"), n_layers=4, d_model=128,
                          d_ff=256, vocab_size=512, head_dim=32)


def lm_prompts(cfg) -> list[np.ndarray]:
    """The reference example's prompts: numpy-seeded, so equal in both
    packages."""
    rng = np.random.default_rng(1)
    return [rng.integers(2, cfg.vocab_size, LM_PROMPT_LEN).astype(np.int32)
            for _ in range(LM_PROMPTS)]


def serve_lm(cfg, params, prompts, tag: str, device=None) -> dict:
    """Serve ``prompts`` (``LM_MAX_TOKENS`` each) through
    ``ServingEngine(max_batch=4, max_len=128)``; prints the run's line and
    returns ``{"out": {rid: tokens}, "tokens", "tok_s", "steps",
    "wall_s"}``."""
    dev = resolve_device(device)
    eng = ServingEngine(cfg, params, max_batch=4, max_len=128, device=dev)
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, max_tokens=LM_MAX_TOKENS))
    t0 = time.perf_counter()
    done = eng.run()
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"  {tag:16s} {toks:3d} tokens  {toks / dt:7.1f} tok/s  "
          f"{eng.steps} engine steps")
    if len(done) != len(prompts) or eng.failed:
        raise AssertionError(f"{tag}: served {len(done)} of {len(prompts)}: "
                             f"{eng.errors}")
    return {"out": {r.rid: r.out for r in done}, "tokens": toks,
            "tok_s": toks / dt, "steps": eng.steps, "wall_s": dt}


def main_lm(cfg, params, prompts, device=None) -> dict:
    """fp32 serving, then W8 and W4 weights dequantized once; prints each
    quantized run's greedy agreement with fp32.  Returns each run's
    :func:`serve_lm` record by tag (``fp32``, ``w8``, ``w4``), the
    quantized ones with their ``agreement``."""
    print("[serve] fp32 baseline vs weight-quantized serving:")
    runs = {"fp32": serve_lm(cfg, params, prompts, "fp32", device)}
    ref = runs["fp32"]["out"]
    for bits in (8, 4):
        qp = quantize_lm_params(params, bits=bits)
        run = serve_lm(cfg, dequantize_tree(qp), prompts, f"w{bits} (dequant)",
                       device)
        run["agreement"] = float(np.mean([run["out"][i] == ref[i]
                                          for i in run["out"]]))
        print(f"    -> greedy agreement with fp32: "
              f"{run['agreement'] * 100:.0f}%")
        runs[f"w{bits}"] = run
    print("[serve] OK")
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--neural-cache", action="store_true",
                    help="serve Inception images through the SLO-aware "
                         "Neural Cache engine instead of the LM")
    ap.add_argument("--slo-ms", type=float, default=5000.0,
                    help="per-request latency SLO for --neural-cache (the "
                         "model calibrates wall vs modeled cycles on the "
                         "fly)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--fault-profile", type=str, default=None,
                    help="seeded fault injection for --neural-cache "
                         "(core/faults.py spec, e.g. 'seed=7,filter=0.1'); "
                         "implies integrity checking")
    ap.add_argument("--compressed", action="store_true",
                    help="plan + execute --neural-cache from the CSR "
                         "bit-plane filter store; logits stay "
                         "byte-identical")
    ap.add_argument("--warmup-replan", action="store_true",
                    help="re-plan --neural-cache after the first batch from "
                         "measured occupancy (warmup batch excluded from "
                         "calibration)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.neural_cache:
        cfg = nc_config()
        params = inception.init_params(torch.Generator().manual_seed(0),
                                       config=cfg, device=dev)
        main_neural_cache(params, cfg, nc_images(cfg, args.requests),
                          args.slo_ms, args.fault_profile,
                          compressed=args.compressed,
                          warmup_replan=args.warmup_replan, device=dev)
    else:
        cfg = lm_config()
        params = T.init_lm(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
        main_lm(cfg, params, lm_prompts(cfg), dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
