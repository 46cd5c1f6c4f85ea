"""§Perf hillclimb: run one (arch x shape x variant) cell of the dry
run and print the roofline delta against the stored baseline (the port of
``repro.launch.perf``, priced on the H100).

    python -m repro_torch.launch.perf --arch olmo-1b --shape train_4k \\
        --variant remat_none [--out results/perf_torch]

Variants are :data:`repro_torch.launch.steps.VARIANTS`; the baseline JSON
is read from ``results/dryrun_torch`` (run the dry run first).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.configs import REGISTRY
from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.steps import VARIANTS

__all__ = ["run_variant", "main"]


def run_variant(arch: str, shape_name: str, variant: str,
                multi_pod: bool = False) -> dict:
    rec = run_cell(arch, shape_name, multi_pod, variant=variant)
    return {"arch": arch, "shape": shape_name, "variant": variant,
            "ok": True, "compile_s": rec["compile_s"],
            "peak_bytes_per_device": rec["peak_bytes_per_device"],
            "roofline": rec["roofline"]}


def delta_line(rec: dict, baseline: dict | None) -> str:
    tag = f"{rec['arch']}__{rec['shape']}__{rec['variant']}"
    rl = rec["roofline"]
    line = (f"{tag}: peak {rec['peak_bytes_per_device']/1e9:.2f} GB | "
            f"comp {rl['t_compute']:.4g}s mem {rl['t_memory']:.4g}s "
            f"coll {rl['t_collective']:.4g}s -> {rl['dominant']}")
    if baseline is not None:
        b = baseline["roofline"]
        for term in ("t_compute", "t_memory", "t_collective"):
            delta = (rl[term] - b[term]) / max(b[term], 1e-12) * 100
            line += f" | {term[2:]} {delta:+.1f}%"
    return line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--variant", required=True, choices=VARIANTS)
    ap.add_argument("--out", default="results/perf_torch")
    ap.add_argument("--baseline-dir", default="results/dryrun_torch")
    args = ap.parse_args()

    rec = run_variant(args.arch, args.shape, args.variant)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{args.arch}__{args.shape}__{args.variant}"
    (out / f"{tag}.json").write_text(json.dumps(rec, indent=1))

    base_path = (pathlib.Path(args.baseline_dir)
                 / f"{args.arch}__{args.shape}__single.json")
    baseline = (json.loads(base_path.read_text()) if base_path.exists()
                else None)
    print(delta_line(rec, baseline))
    return 0


if __name__ == "__main__":
    sys.exit(main())
