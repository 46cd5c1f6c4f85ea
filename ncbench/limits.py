"""The readings that a cell's check limits are set from.

    python3 ncbench/limits.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 11 12 13]

For each seed, on one GPU and in one process: the cell's engine and one
batch of the cell's traffic through ``NCServingEngine.step`` (the timed
path at the timed batch), then the check of a run on the served logits
(the same sample size and reference).  For each control seed, the control
in the program's place: the plain reference computed at four bits, the
precision below the configuration's eight, read by the same comparison.
Prints one JSON line per reading.
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
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
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
    builder = importlib.import_module(f"ncbench.builders.{cfg['builder']}")
    ref = importlib.import_module(f"ncbench.references.{cfg['reference']}")
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = builder.make_params(cfg, gen, dev)
        row = {"workload": cell.name, "seed": seed}
        if seed in args.seeds:
            engine = builder.build_engine(params, cfg, cell.traffic, dev)
            answers, walls, _, _ = harness.serve_window(
                engine, builder, cfg, cell.traffic, seed, dev, 0.0)
            engine = None
            torch.cuda.empty_cache()
            checks, n = harness.check(cell, params, answers, seed, dev,
                                      builder, ref)
            row.update(program={k: v for k, (v, _) in checks.items()},
                       images_checked=n, batch_wall_s=walls[0])
        if seed in args.control_seeds:
            chk = cfg["check"]
            imgs = builder.make_images(cfg, int(chk["sample"]), gen, dev)
            want = ref.logits(params, imgs, cfg, bits=int(cfg["bits"]),
                              block=int(chk["block"]))
            ctl = ref.logits(params, imgs, cfg, bits=4,
                             block=int(chk["block"]))
            row["control_logit_gap"] = float((ctl - want).abs().max())
            row["logit_absmax"] = float(want.abs().max())
            row["control_argmax_agree"] = float(np.mean(
                (ctl.argmax(1) == want.argmax(1)).cpu().numpy()))
        row["seconds"] = time.perf_counter() - t
        params = None
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
