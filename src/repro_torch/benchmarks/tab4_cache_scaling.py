"""Table IV: inference latency vs LLC capacity (35/45/60 MB)."""
from repro_torch.benchmarks.common import row, sim
from repro_torch.core.simulator import PAPER


def run() -> list[str]:
    rows = []
    for mb in (35, 45, 60):
        r = sim(mb)
        rows.append(
            row(f"tab4/{mb}MB", r.latency_s * 1e6,
                f"{r.latency_s*1e3:.2f} ms (paper {PAPER['capacity_ms'][mb]})")
        )
    return rows


if __name__ == "__main__":
    print("\n".join(run()))
