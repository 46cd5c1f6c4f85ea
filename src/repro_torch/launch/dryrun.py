"""Multi-pod dry run: dispatch every (arch x shape x mesh) cell abstractly
(the port of ``repro.launch.dryrun``).

For each cell the dry run:
  1. builds a fake world of 256 (or 512) ranks and the production mesh
     ((16, 16) single-pod / (2, 16, 16) multi-pod),
  2. assembles the sharded step on ``meta`` DTensors
     (:func:`repro_torch.launch.steps.build_sharded_step`) — nothing is
     computed or allocated,
  3. runs it once under :func:`repro_torch.distributed.trace_analysis.analyze_step`:
     FLOPs, bytes and collectives of rank 0's local operations,
  4. prices the step with :func:`repro_torch.distributed.roofline.roofline`
     on :data:`~repro_torch.distributed.roofline.H100_SXM`,
  5. writes one JSON per cell under ``--out`` with the reference's keys.

Memory: ``argument_size_in_bytes`` is exact, the local shard bytes of the
parameters, optimizer state, batch and caches; ``temp_size_in_bytes`` is
the peak of the bytes the step allocated while it ran (the dispatch mode
tracks them), the port's own estimate, not XLA's schedule; ``fits_hbm``
holds their sum against the H100's 80 GiB.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback

from repro_torch import tree
from repro_torch.configs import REGISTRY, get_config, shapes_for
from repro_torch.configs.base import SHAPES
from repro_torch.distributed.roofline import H100_SXM, roofline
from repro_torch.distributed.trace_analysis import analyze_step
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     named_mesh)
from repro_torch.launch.steps import build_sharded_step

__all__ = ["run_cell", "cells", "argument_bytes", "main"]


def argument_bytes(args) -> int:
    """Local shard bytes of every tensor in ``args`` (DTensors by their
    local shard)."""
    total = 0
    for x in tree.leaves(args):
        if hasattr(x, "to_local"):
            x = x.to_local()
        if hasattr(x, "element_size"):
            total += x.numel() * x.element_size()
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, cfg=None,
             spec=None, mesh_shape=None, variant: str = "baseline") -> dict:
    """One cell's record.  ``cfg``/``spec`` override the registry's config
    and shape, and ``mesh_shape`` (a ``(data, model)`` pair) the
    production mesh, for reduced cells."""
    cfg = cfg or get_config(arch)
    spec = spec or SHAPES[shape_name]
    if mesh_shape is not None:
        chips = mesh_shape[0] * mesh_shape[1]
        mesh_name = f"{mesh_shape[0]}x{mesh_shape[1]}"
    else:
        chips = 512 if multi_pod else 256
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    with fake_world(chips):
        mesh = (named_mesh("cuda", tuple(mesh_shape), ("data", "model"))
                if mesh_shape is not None
                else make_production_mesh(multi_pod=multi_pod))
        t0 = time.time()
        bundle = build_sharded_step(cfg, spec, mesh, variant=variant)
        la = analyze_step(bundle.step, *bundle.example_args)
        t_build = time.time() - t0
        args_b = argument_bytes(bundle.example_args)
    mem_d = {"argument_size_in_bytes": args_b,
             "temp_size_in_bytes": la.peak_live_bytes,
             "output_size_in_bytes": None,
             "generated_code_size_in_bytes": None,
             "alias_size_in_bytes": None}
    peak = args_b + la.peak_live_bytes
    cost = {"flops": la.flops, "bytes accessed": la.bytes_accessed}
    rl = roofline(arch, shape_name, mesh_name, chips, cost, la.collectives,
                  bundle.cfg, spec, H100_SXM, peak_memory=peak)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": bundle.kind,
        "compile_s": round(t_build, 1),
        "memory_analysis": mem_d,
        "peak_bytes_per_device": peak,
        "fits_hbm": peak <= H100_SXM.hbm_bytes,
        "cost_analysis": cost,
        "cost_analysis_raw_xla": {},
        "loops": la.loops,
        "collectives": la.collectives.as_dict(),
        "roofline": rl.as_dict(),
        "sharding_fallbacks": bundle.report.fallbacks,
    }


def cells(arch_filter=None, shape_filter=None):
    for arch, cfg in REGISTRY.items():
        if arch_filter and arch != arch_filter:
            continue
        for spec in shapes_for(cfg):
            if shape_filter and spec.name != shape_filter:
                continue
            yield arch, spec.name


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(REGISTRY) + [None])
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = 0
    for arch, shape in cells(args.arch, args.shape):
        for multi in meshes:
            tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
            path = out / f"{tag}.json"
            if args.skip_existing and path.exists():
                ok = json.loads(path.read_text()).get("ok", False)
                if ok:
                    print(f"[skip] {tag}", flush=True)
                    continue
            print(f"[cell] {tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape, multi)
                rec["ok"] = True
                print(f"  ok: peak={rec['peak_bytes_per_device']/1e9:.2f} GB"
                      f" dominant={rec['roofline']['dominant']}"
                      f" dispatch={rec['compile_s']}s", flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                failures += 1
                rec = {"arch": arch, "shape": shape,
                       "mesh": "multi" if multi else "single",
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                print(f"  FAIL: {type(e).__name__}: {str(e)[:200]}\n"
                      f"{rec['traceback'][-1500:]}", flush=True)
            path.write_text(json.dumps(rec, indent=1))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
