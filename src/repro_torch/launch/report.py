"""Generate the §Dry-run and §Roofline tables from the port's dry-run JSONs
(the port of ``repro.launch.report``; capacity and rates are the H100's).

    python -m repro_torch.launch.report [--results results/dryrun_torch]
                                        [--out EXPERIMENTS_torch.md]

Everything between <!-- BEGIN AUTOGEN --> and <!-- END AUTOGEN --> of the
output file is replaced; hand-written text around it stays.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.distributed.roofline import H100_SXM

MARK_BEGIN = "<!-- BEGIN AUTOGEN (repro_torch.launch.report) -->"
MARK_END = "<!-- END AUTOGEN -->"

_CAPACITY = f"{H100_SXM.hbm_bytes / 2**30:.0f} GiB"  # 80 GiB

_ADVICE = {
    "compute": "compute-bound: raise tensor-core utilization (larger per-card"
               " tiles, fewer remat recomputes)",
    "memory": "HBM-bound: fuse epilogues / cut activation round-trips"
              " (quantized weights halve the stream)",
    "collective": "NVLink-bound: overlap collectives with compute or reshard"
                  " to cut cross-card traffic",
}


def _gb(x):
    return "-" if x is None else f"{x/1e9:.2f}"


def load(results: pathlib.Path):
    return [json.loads(p.read_text()) for p in sorted(results.glob("*.json"))]


def dryrun_table(recs) -> str:
    lines = [
        f"| arch | shape | mesh | compiles | peak GB/dev | fits {_CAPACITY} | "
        "GFLOPs/dev | HLO GB/dev | coll GB/dev (wire) | collective ops | "
        "compile s |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not r.get("ok"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | **FAIL** "
                f"| - | - | - | - | - | {r.get('error','')[:60]} | - |")
            continue
        rl = r["roofline"]
        ops = ", ".join(f"{k}x{v}" for k, v in
                        sorted(r["collectives"]["ops"].items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {_gb(r['peak_bytes_per_device'])} "
            f"| {'yes' if r['fits_hbm'] else 'NO'} "
            f"| {rl['hlo_flops_per_device']/1e9:,.0f} "
            f"| {rl['hlo_bytes_per_device']/1e9:,.1f} "
            f"| {rl['collective_wire_bytes_per_device']/1e9:,.2f} "
            f"| {ops} | {r['compile_s']} |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | mesh | t_compute s | t_memory s | t_collective s |"
        " dominant | MODEL_FLOPS | useful ratio | roofline frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not r.get("ok"):
            continue
        if r["mesh"] != "pod16x16":
            continue  # the roofline table is single-pod
        rl = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {rl['t_compute']:.4g} | {rl['t_memory']:.4g} "
            f"| {rl['t_collective']:.4g} | **{rl['dominant']}** "
            f"| {rl['model_flops_total']:.3g} "
            f"| {rl['useful_flops_ratio']:.3f} "
            f"| {rl['roofline_fraction']:.3f} "
            f"| {_ADVICE[rl['dominant']]} |")
    return "\n".join(lines)


def summary(recs) -> str:
    ok = [r for r in recs if r.get("ok")]
    fails = [r for r in recs if not r.get("ok")]
    single = [r for r in ok if r["mesh"] == "pod16x16"]
    multi = [r for r in ok if r["mesh"] != "pod16x16"]
    fits = sum(1 for r in ok if r["fits_hbm"])
    dom = {}
    for r in single:
        d = r["roofline"]["dominant"]
        dom[d] = dom.get(d, 0) + 1
    return (
        f"- cells dispatched: **{len(ok)}/{len(recs)}** "
        f"({len(single)} single-pod + {len(multi)} multi-pod; "
        f"{len(fails)} failures)\n"
        f"- fit in {_CAPACITY}/card HBM (H100): {fits}/{len(ok)}\n"
        f"- dominant roofline term (single-pod): "
        + ", ".join(f"{k} x{v}" for k, v in sorted(dom.items())))


def render(results_dir: str) -> str:
    recs = load(pathlib.Path(results_dir))
    h = H100_SXM
    return "\n".join([
        MARK_BEGIN,
        "",
        "### Summary",
        "",
        summary(recs),
        "",
        "### §Dry-run — every (arch x shape) x both meshes",
        "",
        "Per-device numbers of rank 0's local operations on a fake world"
        " (`repro_torch.distributed.trace_analysis`; eager, unfused).",
        "",
        dryrun_table(recs),
        "",
        "### §Roofline — three terms per cell (single-pod, 256 cards)",
        "",
        f"Terms: compute = FLOPs/(chips x {h.peak_flops/1e12:g} TF/s),"
        f" memory = bytes/(chips x {h.hbm_bw/1e12:g} TB/s), collective ="
        f" wire-bytes/(chips x {h.ici_bw/1e9:g} GB/s) (H100 SXM datasheet"
        " values, NVLink on every link); `useful ratio` ="
        " 6·N_active·D / counted FLOPs; `roofline frac` ="
        " t_compute / max(term) (1.0 = compute-bound).",
        "",
        roofline_table(recs),
        "",
        MARK_END,
    ])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_torch")
    ap.add_argument("--out", default="EXPERIMENTS_torch.md")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    block = render(args.results)
    if out.exists() and MARK_BEGIN in out.read_text():
        text = out.read_text()
        pre = text.split(MARK_BEGIN)[0]
        post = text.split(MARK_END)[-1]
        out.write_text(pre + block + post)
    else:
        body = out.read_text() if out.exists() else ""
        out.write_text(body + "\n" + block + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
