"""The readings that an LM cell's check limits are set from.

    python3 ncbench/limits_lm.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 11 12 13]

For each seed, on one GPU and in one process: the cell's engine and one
batch of the cell's traffic through the window's own loop (the timed path
at the timed batch), then the check's comparison on the kept logits (the
sample ``harness.check`` draws, the same reference), with the gap at each
kept step and the largest logit.  For each control seed, the control in
the program's place: the plain reference with its weights rounded to
float8 e4m3 (``bits=8``), the precision below the configuration's 16
bits, read by the same comparison on the same sample (a seed's first
``sample`` requests where the seed has no program reading).  Prints one
JSON line per seed.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import importlib

    import numpy as np
    import torch

    from ncbench import harness

    if not torch.cuda.is_available():
        harness.log("[limits] needs a CUDA device")
        return 3
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    cell = harness.Cell.find(harness.load_json(ROOT / "BENCHMARK.json"),
                             args.workload, ROOT)
    cfg = cell.config
    cfg["traffic"] = dict(cell.traffic)
    builder = importlib.import_module(f"ncbench.builders.{cfg['builder']}")
    ref = importlib.import_module(f"ncbench.references.{cfg['reference']}")
    chk = cfg["check"]
    B = int(cell.traffic["batch"])
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        params = builder.make_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        row = {"workload": cell.name, "seed": seed,
               "setup_s": time.perf_counter() - t}
        rows = harness.batch_images(builder, cfg, seed, 0, B, dev)
        n = min(int(chk["sample"]), B)
        if seed in args.seeds:
            engine = builder.build_engine(params, cfg, cell.traffic, dev)
            answers, walls, _, _ = harness.serve_window(
                engine, builder, cfg, cell.traffic, seed, dev, 0.0)
            engine = None
            torch.cuda.empty_cache()
            # the check's own sample (``harness.check``) of the one batch
            ok = [a for a in answers if a[2]]
            pick = sorted(np.random.default_rng(seed).choice(
                len(ok), size=min(n, len(ok)), replace=False).tolist())
            sample = torch.stack([rows[ok[k][1]] for k in pick])
            served = torch.stack([ok[k][3] for k in pick]).float()
            answers = None
        else:
            sample = rows[:n]
        t_ref = time.perf_counter()
        want = ref.logits(params, sample, cfg, block=int(chk["block"]))
        row["reference_s"] = time.perf_counter() - t_ref
        row.update(logit_absmax=float(want.abs().max()),
                   logit_std=float(want.std()))
        if seed in args.seeds:
            gap = (served - want).abs()
            row.update(program={"logit_gap": float(gap.max()),
                                "failed_requests": B - len(ok)},
                       requests_checked=len(pick), batch_wall_s=walls[0],
                       step_gaps=gap.amax((0, 2)).tolist())
            served = None
        if seed in args.control_seeds:
            ctl = ref.logits(params, sample, cfg, bits=8,
                             block=int(chk["block"]))
            row["control_logit_gap"] = float((ctl - want).abs().max())
            row["control_step_gaps"] = (ctl - want).abs().amax(
                (0, 2)).tolist()
            row["control_argmax_agree"] = float(
                (ctl.argmax(-1) == want.argmax(-1)).float().mean())
            ctl = None
        row["seconds"] = time.perf_counter() - t
        params = want = None
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
