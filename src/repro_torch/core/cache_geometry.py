"""Cache geometry of the modeled Xeon-E5 LLC (paper §II-C, Figure 3).

Hierarchy: processor -> 14 x 2.5MB slices -> 20 ways/slice -> 4 banks/way
(80 32KB banks per slice) -> 4 x 8KB SRAM arrays/bank -> 256x256 bit cells.

Way-20 is reserved for normal CPU operation, way-19 for input/output staging;
the remaining 18 ways compute.  Frequencies/energies come from the paper's
28nm SPICE model scaled to 22nm (§V): compute mode 2.5 GHz @ 15.4 pJ/cycle
per array, SRAM-access mode 4 GHz @ 8.6 pJ/cycle.
"""
from __future__ import annotations

import dataclasses

__all__ = ["CacheGeometry", "XEON_E5_35MB", "XEON_45MB", "XEON_60MB"]


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    name: str = "xeon-e5-2697v3-35MB"
    n_slices: int = 14
    ways: int = 20
    reserved_cpu_ways: int = 1  # way-20: normal processing
    reserved_io_ways: int = 1  # way-19: input/output staging
    banks_per_way: int = 4  # 80 banks / 20 ways
    arrays_per_bank: int = 4  # 32KB bank = 2 x 16KB sub-array = 4 x 8KB array
    array_rows: int = 256  # word lines
    array_cols: int = 256  # bit lines
    compute_freq_hz: float = 2.5e9
    access_freq_hz: float = 4.0e9
    compute_energy_pj: float = 15.4  # per array per compute cycle (22nm)
    access_energy_pj: float = 8.6  # per array per access cycle (22nm)
    bus_bits: int = 256  # intra-slice data bus (4 x 64-bit quadrant buses)

    # ---- derived -----------------------------------------------------------
    @property
    def compute_ways(self) -> int:
        return self.ways - self.reserved_cpu_ways - self.reserved_io_ways

    @property
    def arrays_per_way(self) -> int:
        return self.banks_per_way * self.arrays_per_bank

    @property
    def arrays_per_slice(self) -> int:
        return self.ways * self.arrays_per_way

    @property
    def compute_arrays_per_slice(self) -> int:
        return self.compute_ways * self.arrays_per_way

    @property
    def compute_arrays(self) -> int:
        return self.n_slices * self.compute_arrays_per_slice

    @property
    def total_arrays(self) -> int:
        return self.n_slices * self.arrays_per_slice

    @property
    def alu_slots(self) -> int:
        """Bit-serial ALU slots = every bit line in the cache (paper: 1,146,880)."""
        return self.total_arrays * self.array_cols

    @property
    def compute_slots(self) -> int:
        return self.compute_arrays * self.array_cols

    @property
    def array_bytes(self) -> int:
        return self.array_rows * self.array_cols // 8

    @property
    def capacity_bytes(self) -> int:
        return self.total_arrays * self.array_bytes

    @property
    def io_way_bytes(self) -> int:
        """Reserved-way staging capacity (128 KB per slice on the 35MB part)."""
        return self.n_slices * self.reserved_io_ways * self.arrays_per_way * self.array_bytes

    def scaled(self, n_slices: int, name: str | None = None) -> "CacheGeometry":
        return dataclasses.replace(
            self, n_slices=n_slices, name=name or f"scaled-{n_slices}slices"
        )


XEON_E5_35MB = CacheGeometry()
XEON_45MB = XEON_E5_35MB.scaled(18, "xeon-45MB")
XEON_60MB = XEON_E5_35MB.scaled(24, "xeon-60MB")
