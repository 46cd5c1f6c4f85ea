"""Run one cell of the benchmark and print its result line.

    python3 ncbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Needs the GPUs the cell asks for; without
them it exits with code 3 and prints no result.  The last line of standard
output is the JSON result; the numbers the check compared, each beside its
limit, are the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / "build" / "ncbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from ncbench import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    try:
        cell = harness.Cell.find(manifest, args.workload, ROOT)
    except (KeyError, OSError) as e:
        harness.log(f"[ncbench] {e}")
        return 2
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"[ncbench] {cell.name} needs {chips} CUDA device(s); "
                    f"found {torch.cuda.device_count()}")
        return 3
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START, chips=chips)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"[ncbench] loaded in this process: {found}")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
