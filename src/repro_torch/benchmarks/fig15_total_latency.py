"""Figure 15: total Inception v3 inference latency, NC vs CPU vs GPU."""
from repro_torch.benchmarks.common import row, sim
from repro_torch.core.simulator import PAPER


def run() -> list[str]:
    r = sim()
    nc_ms = r.latency_s * 1e3
    return [
        row("fig15/neural_cache", nc_ms * 1e3, "modeled"),
        row("fig15/cpu_xeon_e5", PAPER["cpu_latency_ms"] * 1e3, "paper-measured baseline"),
        row("fig15/gpu_titan_xp", PAPER["gpu_latency_ms"] * 1e3, "paper-measured baseline"),
        row("fig15/speedup_vs_cpu", 0.0, f"{PAPER['cpu_latency_ms']/nc_ms:.1f}x (paper 18.3x)"),
        row("fig15/speedup_vs_gpu", 0.0, f"{PAPER['gpu_latency_ms']/nc_ms:.1f}x (paper 7.7x)"),
    ]


if __name__ == "__main__":
    print("\n".join(run()))
