"""The batch sweep that fixes the throughput traffic's batch.

    python3 ncbench/sweep.py --config inception_v3-hostq --batches 64 32 16

For each batch B, on one GPU: the configuration's engine at ``max_batch=B``
(from the configuration's builder), one cold batch of B seeded images
through the window's own loop (``harness.serve_window``), one warm batch
timed on the host clock, and one traced batch for the device's idle
share; the peak memory of each B on its own.  Prints one JSON line per B.
The traffic takes the largest B of which at least three whole batches fit
into a window of at most 51 s and whose peak fits the card.
"""
import argparse
import importlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="inception_v3-hostq")
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 32, 16])
    ap.add_argument("--seed", type=int, default=20261018)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from ncbench import harness
    from ncbench import trace as _trace

    if not torch.cuda.is_available():
        harness.log("[sweep] needs a CUDA device")
        return 3
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # a context before the memory statistics
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    conf = {c["name"]: c for c in manifest["configs"]}[args.config]
    cfg = harness.load_json(ROOT / conf["file"])
    builder = importlib.import_module(f"ncbench.builders.{cfg['builder']}")

    for B in args.batches:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        traffic = {"batch": B}
        row = {"batch": B}
        try:
            params = builder.make_params(cfg, gen, dev)
            engine = builder.build_engine(params, cfg, traffic, dev)
            walls = [harness.serve_window(engine, builder, cfg, traffic,
                                          args.seed, dev, 0.0)[1][0]
                     for _ in range(2)]
            with _trace.device_profile(dev) as tr:
                _, _, t0, t1 = harness.serve_window(
                    engine, builder, cfg, traffic, args.seed, dev, 0.0)
            s = _trace.summarize(tr, t0, t1, [])
            row.update(traced_wall_s=(t1 - t0) / 1e9, busy_s=s["busy_s"],
                       idle_share=1 - s["busy_s"] * 1e9 / (t1 - t0),
                       device_ops=s["device_ops"][:5],
                       events=len(tr["names"]))
            row.update(cold_wall_s=walls[0], warm_wall_s=walls[1],
                       images_per_s=B / walls[1],
                       batches_in_51s=int(51 // walls[1]),
                       peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                       failed=len(engine.failed))
        except torch.cuda.OutOfMemoryError as e:
            row["error"] = f"out of memory: {e}"[:300]
        engine = params = None
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
