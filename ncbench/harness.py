"""One run of one cell: set-up, the measured window, the trace, the check.

The manifest (``BENCHMARK.json``) names the cell; its configuration,
traffic mix and per-layer metric readers are files of their own, found by
name.  Nothing here depends on one cell.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np
import torch

from ncbench import spans as _spans
from ncbench import trace as _trace

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    manifest: dict
    workload: dict
    config: dict
    traffic: dict

    @classmethod
    def find(cls, manifest: dict, name: str, root: pathlib.Path) -> "Cell":
        wl = {w["name"]: w for w in manifest["workloads"]}.get(name)
        if wl is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
        return cls(name, manifest, wl, load_json(root / conf["file"]),
                   load_json(HERE / "traffic" / f"{wl['traffic']}.json"))

    def end_to_end(self) -> list[dict]:
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        return [m for m in self.manifest["per_layer"]
                if self.name in m["workloads"]]


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level packages among ``names`` (default: the
    modules this process has loaded), compared as whole names."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def read_metric(name: str, ctx: dict):
    """Run the reader ``metrics/<name>.py`` on ``ctx``; None when it finds
    nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "ncbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_info(device, count: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def batch_images(builder, cfg, seed: int, index: int, n: int, device):
    """Batch ``index`` of a run's seeded images (-1: the warm-up batch),
    drawn anew from ``seed`` and ``index`` whenever it is needed."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + index + 1) % 2 ** 63)
    return builder.make_images(cfg, n, gen, device)


def serve_window(engine, builder, cfg, traffic, seed, device, seconds,
                 recorder=None):
    """Closed loop: keep one batch of seeded images queued and step the
    engine until ``seconds`` have passed, then stop at the end of the batch
    in flight.  Each batch's answers are collected as a client takes them,
    and its images let go.  Returns ``(answers, batch walls, t0_ns,
    t1_ns)``, an answer being ``(batch index, position, ok, output)``; the
    window runs from ``t0_ns`` to the synchronized end of its last batch."""
    B = int(traffic["batch"])
    answers, walls = [], []
    _sync(device)
    t0 = time.perf_counter_ns()
    while True:
        i = len(walls)
        batch = [builder.request(i * B + j, img) for j, img in enumerate(
            batch_images(builder, cfg, seed, i, B, device))]
        for r in batch:
            engine.submit(r)
        tb = time.perf_counter_ns()
        if recorder is None:
            engine.step()
        else:
            with recorder.span("serve"):
                engine.step()
        _sync(device)
        t1 = time.perf_counter_ns()
        walls.append((t1 - tb) / 1e9)
        answers += [(i, j, ok, out) for j, (ok, out) in
                    enumerate(builder.collect(engine, batch))]
        del batch
        if t1 - t0 >= seconds * 1e9:
            return answers, walls, t0, t1


def check(cell: Cell, params, answers, seed: int, device, builder, ref_mod):
    """Hold a seeded sample of the window's answers against the plain
    reference, on images drawn again from the seed.  Returns
    ``({number: (value, limit)}, images checked)``."""
    chk = cell.config["check"]
    B = int(cell.traffic["batch"])
    ok = [a for a in answers if a[2]]
    rng = np.random.default_rng(seed)
    pick = sorted(rng.choice(len(ok), size=min(int(chk["sample"]), len(ok)),
                             replace=False).tolist()) if ok else []
    gap = float("inf")
    if pick:
        drawn = {}
        for i in sorted({ok[k][0] for k in pick}):
            drawn[i] = batch_images(builder, cell.config, seed, i, B, device)
        images = torch.stack([drawn[ok[k][0]][ok[k][1]] for k in pick])
        served = torch.stack([ok[k][3] for k in pick]).to(torch.float32)
        want = ref_mod.logits(params, images, cell.config,
                              bits=int(cell.config["bits"]),
                              block=int(chk["block"]))
        gap = float((served - want).abs().max())
    lim = chk["limits"]
    return {"logit_gap": (gap, float(lim["logit_gap"])),
            "failed_requests": (len(answers) - len(ok),
                                int(lim["failed_requests"]))}, len(pick)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, chips: int = 1) -> dict:
    """One run of ``cell``; returns the result line as a dict.  Raises when
    set-up, the window or the check cannot run: the caller then prints no
    result."""
    cfg, traffic = cell.config, cell.traffic
    builder = importlib.import_module(f"ncbench.builders.{cfg['builder']}")
    ref_mod = importlib.import_module(f"ncbench.references.{cfg['reference']}")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = builder.make_params(cfg, gen, device)
    engine = builder.build_engine(params, cfg, traffic, device)
    B = int(traffic["batch"])
    # warm-up: one batch of the cell's own shape
    warm = [builder.request(-1 - i, img) for i, img in
            enumerate(batch_images(builder, cfg, seed, -1, B, device))]
    t_w = time.perf_counter()
    for r in warm:
        engine.submit(r)
    engine.step()
    _sync(device)
    warm_s = time.perf_counter() - t_w
    if not all(ok for ok, _ in builder.collect(engine, warm)):
        raise RuntimeError("the warm-up batch failed")
    del warm
    gc.collect()
    gc.freeze()  # set-up's objects leave the collector's generations
    setup_s = time.perf_counter() - t_start
    log(f"[ncbench] {cell.name}: set-up {setup_s:.3f} s (warm-up batch of "
        f"{B}: {warm_s:.3f} s)")

    recorder = tr = None
    n_launch0 = builder.launches()
    if trace:
        recorder = _spans.SpanRecorder(device)
        with recorder.patched(builder.SPANS), \
                _trace.device_profile(device) as tr:
            answers, walls, t0, t1 = serve_window(
                engine, builder, cfg, traffic, seed, device, seconds,
                recorder=recorder)
    else:
        answers, walls, t0, t1 = serve_window(engine, builder, cfg, traffic,
                                              seed, device, seconds)
    gc.unfreeze()
    window_s = (t1 - t0) / 1e9
    n_launch = builder.launches() - n_launch0
    info = _device_info(device, chips)
    images = len(answers)
    log(f"[ncbench] window {window_s:.3f} s: {len(walls)} batches of {B}, "
        f"walls {', '.join(f'{w:.3f}' for w in walls)} s; kernel-1 "
        f"launches {n_launch}; peak {info['memory_peak_bytes']} B")

    metrics, breakdown = {}, None
    if not trace:
        values = {"images_per_s": images / window_s,
                  "peak_mem_gib": info["memory_peak_bytes"] / 2 ** 30,
                  "setup_s": setup_s}
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        summary = _trace.summarize(tr, t0, t1, recorder.segments())
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = window_s
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
        ctx = dict(config=cfg, traffic=traffic, images=images,
                   batches=len(walls), window_s=window_s,
                   spans=recorder.totals(), kernel_s=summary["kernel_s"],
                   busy_s=summary["busy_s"])
        for m in cell.per_layer():
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        del tr

    # the check: after the window and the memory reading, with the
    # program's state freed
    engine = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    checks, n_checked = check(cell, params, answers, seed, device, builder,
                              ref_mod)
    log(f"[ncbench] check of {n_checked} images: "
        f"{time.perf_counter() - t_c:.3f} s")
    correct = all(val <= lim for val, lim in checks.values())
    for k, (val, lim) in checks.items():
        log(f"{k} {val!r} limit {lim!r}")
    result = {"correct": bool(correct), "attempted": images,
              "failed": int(checks["failed_requests"][0]),
              "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
