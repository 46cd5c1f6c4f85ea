"""Table III: energy per inference and average power."""
from repro_torch.benchmarks.common import row, sim
from repro_torch.core.simulator import PAPER


def run() -> list[str]:
    r = sim()
    return [
        row("tab3/nc_energy_j", r.energy_j * 1e6, f"{r.energy_j:.3f} J (paper 0.246)"),
        row("tab3/nc_power_w", 0.0, f"{r.power_w:.1f} W (paper 52.92)"),
        row("tab3/cpu_energy_j", PAPER["cpu_energy_j"] * 1e6, "paper-measured"),
        row("tab3/gpu_energy_j", PAPER["gpu_energy_j"] * 1e6, "paper-measured"),
        row("tab3/efficiency_vs_cpu", 0.0, f"{PAPER['cpu_energy_j']/r.energy_j:.1f}x (paper 37.1x)"),
        row("tab3/efficiency_vs_gpu", 0.0, f"{PAPER['gpu_energy_j']/r.energy_j:.1f}x (paper 16.6x)"),
    ]


if __name__ == "__main__":
    print("\n".join(run()))
