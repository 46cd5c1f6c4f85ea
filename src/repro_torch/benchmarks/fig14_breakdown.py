"""Figure 14: Neural Cache inference latency breakdown."""
from repro_torch.benchmarks.common import row, sim
from repro_torch.core.simulator import PAPER


def run() -> list[str]:
    r = sim()
    rows = []
    for key, frac in r.breakdown().items():
        # the f-string prints "%%" as two characters, as the reference's
        # rows do
        rows.append(
            row(f"fig14/{key}", frac * r.latency_s * 1e6,
                f"{frac*100:.2f}%% of total (paper {PAPER['breakdown'][key]*100:.2f}%%)")
        )
    return rows


if __name__ == "__main__":
    print("\n".join(run()))
