"""Reproduce every Neural Cache figure/table from the paper in one run, on
the port.

Prints the paper's number next to ours for:
  Fig 13 (per-layer latency), Fig 14 (latency breakdown), Fig 15 (total
  latency + speedups), Fig 16 (throughput vs batch), Table III (energy /
  power), Table IV (cache-capacity scaling).

Every row is the simulator's modeled time on the paper's Xeon caches (or
a paper-measured baseline), not a time of this machine.  The lines equal
the reference example's byte for byte.

Run:  python -m repro_torch.examples.paper_repro [--device cpu]

The rows need no device work; ``--device`` (default ``cuda``) follows the
port's rule for entry points: ``cuda`` needs a GPU, ``cpu`` runs without
one.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks import (fig13_latency_by_layer, fig14_breakdown,
                                    fig15_total_latency,
                                    fig16_throughput_batch, tab3_energy,
                                    tab4_cache_scaling)
from repro_torch.device import resolve_device

MODULES = [
    ("Fig 13 latency by layer", fig13_latency_by_layer),
    ("Fig 14 breakdown", fig14_breakdown),
    ("Fig 15 total latency", fig15_total_latency),
    ("Fig 16 throughput vs batch", fig16_throughput_batch),
    ("Table III energy/power", tab3_energy),
    ("Table IV capacity scaling", tab4_cache_scaling),
]


def paper_lines() -> list[str]:
    """The example's output lines (without the trailing newline)."""
    out = []
    for title, mod in MODULES:
        out += ["", f"=== {title} ==="]
        out += [f"  {line}" for line in mod.run()]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) needs a GPU; cpu runs without one")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    print("\n".join(paper_lines()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
