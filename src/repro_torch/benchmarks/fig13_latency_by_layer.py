"""Figure 13: inference latency by layer of Inception v3 on Neural Cache."""
from collections import defaultdict

from repro_torch.benchmarks.common import row, sim


def run() -> list[str]:
    r = sim()
    per_block = defaultdict(float)
    for l in r.layers:
        per_block[l.spec.block] += l.total_s
    rows = []
    for block, t in per_block.items():
        rows.append(row(f"fig13/{block}", t * 1e6, f"neural-cache layer latency"))
    rows.append(row("fig13/TOTAL", r.latency_s * 1e6, "sum over layers"))
    return rows


if __name__ == "__main__":
    print("\n".join(run()))
