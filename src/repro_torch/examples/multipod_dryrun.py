"""One multi-pod dry-run cell with its roofline, on the port.

Builds qwen2-7b x train_4k on the 2 x 16 x 16 production mesh of a fake
512-rank world, dispatches its sharded step on meta tensors
(:func:`repro_torch.launch.dryrun.run_cell`), then prints the record as
JSON, the peak bytes a device against the H100's memory, and the three
roofline terms priced on ``H100_SXM`` with the dominant one.

Run:  python -m repro_torch.examples.multipod_dryrun [arch] [shape] [--device cpu]
      python -m repro_torch.examples.multipod_dryrun --reduced --device cpu

The cell is dispatched abstractly on the host either way; ``--device``
(default ``cuda``) follows the port's rule for entry points: ``cuda``
needs a GPU, ``cpu`` runs without one.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.distributed.roofline import H100_SXM
from repro_torch.launch import dryrun

REDUCED_SHAPE = (64, 4)  # --reduced: (seq_len, global batch)


def dryrun_cell(arch: str = "qwen2-7b", shape: str = "train_4k", *,
                cfg=None, spec=None, mesh_shape=None) -> dict:
    """Run the cell on the multi-pod mesh (``cfg``, ``spec`` and a
    ``(data, model)`` ``mesh_shape`` override it for a reduced cell) and
    print it; returns the record."""
    rec = dryrun.run_cell(arch, shape, True, cfg=cfg, spec=spec,
                          mesh_shape=mesh_shape)
    print(json.dumps(rec, indent=1))
    rl = rec["roofline"]
    print(f"\n[{arch} x {shape} @ {rec['mesh']}]")
    print(f"  peak {rec['peak_bytes_per_device'] / 1e9:.2f} GB/device, "
          f"fits {H100_SXM.hbm_bytes / 2 ** 30:.0f} GiB HBM (H100): "
          f"{rec['fits_hbm']}")
    print(f"  compute {rl['t_compute'] * 1e3:.2f} ms | memory "
          f"{rl['t_memory'] * 1e3:.2f} ms | collective "
          f"{rl['t_collective'] * 1e3:.2f} ms -> {rl['dominant']}-bound")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="qwen2-7b")
    ap.add_argument("shape", nargs="?", default="train_4k")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) needs a GPU; cpu runs without one")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config at 64 tokens x 4 on a "
                         "(2, 2) mesh of a fake 4-rank world (seconds)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    kw = {}
    if args.reduced:
        kw = dict(cfg=reduced_config(get_config(args.arch)),
                  spec=ShapeSpec(args.shape, *REDUCED_SHAPE,
                                 SHAPES[args.shape].kind),
                  mesh_shape=(2, 2))
    dryrun_cell(args.arch, args.shape, **kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
