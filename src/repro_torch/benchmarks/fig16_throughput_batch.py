"""Figure 16: throughput (inferences/s) vs batch size."""
from repro_torch.benchmarks.common import row, sim
from repro_torch.core.simulator import PAPER, throughput


def run() -> list[str]:
    r = sim()
    rows = []
    for b in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        tp = throughput(r, b)
        rows.append(row(f"fig16/batch_{b}", 1e6 / tp, f"{tp:.1f} inf/s (dual socket)"))
    tp64 = throughput(r, 64)
    rows.append(row("fig16/vs_cpu", 0.0, f"{tp64/PAPER['cpu_throughput']:.1f}x (paper 12.4x)"))
    rows.append(row("fig16/vs_gpu", 0.0, f"{tp64/PAPER['gpu_throughput']:.1f}x (paper 2.2x)"))
    return rows


if __name__ == "__main__":
    print("\n".join(run()))
