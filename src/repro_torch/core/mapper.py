"""Data-layout mapper: DNN layers -> cache geometry (paper §IV-A/B).

Implements the paper's mapping algorithm:
  * filter splitting  — filters larger than 9 bytes split across bit lines,
  * filter packing    — 1x1 filters pack up to 16 channels per bit line,
  * channel rounding  — effective channels rounded up to a power of two
                        (zero padding), guaranteed to fit in <=2 arrays
                        (512 bit lines) that share sense amps,
  * replication       — filters replicated across arrays/ways/slices so all
                        M x E x E convolutions run in parallel to the extent
                        the geometry allows; the remainder is serialized.

Validated against the paper's two worked examples:
  Conv2D_2b_3x3 (R x S=9, C=32, M=64, E=147): 8 filters/array, 32,256 parallel,
  43 serial passes, 99.7% utilization (§VI-A).
  Figure-9 layer (R x S=9, C=128, M=32, E=32): 2 filters/array, 18x32/slice,
  ~4 serial passes (§IV-B).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Literal

from repro_torch.core.cache_geometry import CacheGeometry, XEON_E5_35MB

__all__ = ["LayerSpec", "MappedLayer", "map_layer", "map_network",
           "serial_passes_for", "compressed_filter_bytes"]

MAX_FILTER_BYTES_PER_LINE = 9  # filter splitting threshold (§IV-A)
MAX_PACK_BYTES = 16  # 1x1 filter packing factor (§IV-A)
MAX_REDUCE_LINES = 512  # two arrays sharing sense amps (§III-D)

LayerKind = Literal["conv", "fc", "maxpool", "avgpool"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Geometry of one layer (one *branch* of a mixed block is one spec)."""

    name: str
    kind: LayerKind
    H: int  # input height (=width)
    R: int  # filter height
    S: int  # filter width
    C: int  # input channels
    M: int  # output channels (filter batches)
    E: int  # output height (=width)
    stride: int = 1
    block: str = ""  # mixed-block grouping for per-layer reports

    @property
    def filter_elems(self) -> int:
        return self.R * self.S

    @property
    def conv_count(self) -> int:
        """One convolution per output element (paper Table I 'Conv')."""
        return self.M * self.E * self.E if self.kind in ("conv", "fc") else 0

    @property
    def window_count(self) -> int:
        """Pooling windows (pooling layers do comparisons, not MACs)."""
        return self.M * self.E * self.E if self.kind in ("maxpool", "avgpool") else 0

    @property
    def filter_bytes(self) -> int:
        return self.R * self.S * self.C * self.M if self.kind in ("conv", "fc") else 0

    @property
    def input_bytes(self) -> int:
        return self.H * self.H * self.C

    @property
    def output_bytes(self) -> int:
        return self.M * self.E * self.E


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def serial_passes_for(work: int, parallel: int) -> int:
    """Serialized passes to cover ``work`` convolutions/windows at
    ``parallel`` per pass (§IV-B) — 0 when there is no work at all.

    The ONE serialization rule shared by :func:`map_layer` (dense pass
    counts) and core/schedule.py's sparsity-aware planner (pass counts over
    the pruned filter set), so mapper and scheduler can never disagree on
    how work rounds up into passes."""
    if work <= 0:
        return 0
    return max(1, math.ceil(work / max(parallel, 1)))


def pass_filter_bytes(filter_bytes: int, passes: int) -> int:
    """Filter bytes streamed per serialized pass when a layer's load is
    spread over its pass sequence (§IV-E double buffering) — 0 when the
    layer loads nothing.

    The ONE per-pass filter-streaming rule shared by core/schedule.py's
    overlap-legality decision (does one pass's worth of columns fit the
    reserved I/O way?) and core/simulator.py's prologue pricing (the first
    pass's load can never hide), so scheduler and simulator can never
    disagree on how a layer's filter bytes split across passes."""
    if filter_bytes <= 0:
        return 0
    return math.ceil(filter_bytes / max(passes, 1))


def compressed_filter_bytes(resident_bytes: int, total_filters: int,
                            plane_bits: int = 8,
                            live_planes: int | None = None) -> int:
    """Resident bytes of the CSR bit-plane filter store (EIE-style
    compressed §IV-A residency) — 0 when the layer loads nothing.

    ``resident_bytes`` is the uncompressed residency of the live filter
    set (pruned columns are already not stored).  Compression keeps only
    the ``live_planes`` bit planes that contain any set bit — the payload
    scales by the live-plane fraction — plus, per live plane, a
    live-column bitmap over the layer's ``total_filters`` columns (the
    CSR index: one bit per filter column, byte-rounded).

    The ONE compressed-residency rule shared by core/schedule.py's
    ``plan_layer(compressed=True)`` (residency, per-pass streaming and
    overlap headroom all derive from it) and the simulator's residency
    credit (dense − compressed priced at filter bandwidth), so planner
    and pricer can never disagree on what compression saves."""
    if resident_bytes <= 0:
        return 0
    if live_planes is None:
        live_planes = plane_bits
    live_planes = max(0, min(int(live_planes), int(plane_bits)))
    payload = math.ceil(resident_bytes * live_planes / max(plane_bits, 1))
    index = live_planes * math.ceil(max(total_filters, 1) / 8)
    return payload + index


@dataclasses.dataclass(frozen=True)
class MappedLayer:
    spec: LayerSpec
    split_factor: int  # filter split across bit lines
    pack_factor: int  # channels packed per bit line (1x1 filters)
    line_filter_bytes: int  # R'xS': filter bytes held by one bit line
    eff_channels: int  # C' after split/pack
    channels_rounded: int  # next pow2, <= MAX_REDUCE_LINES
    lines_per_filter: int  # bit lines holding one logical filter
    filters_per_array: float  # parallel convolutions per 8KB array (0.5 = 2 arrays)
    parallel_convs: int  # across the whole cache
    serial_passes: int
    utilization: float

    @property
    def reduction_steps(self) -> int:
        return int(math.log2(self.channels_rounded)) if self.channels_rounded > 1 else 0

    @property
    def macs_per_line(self) -> int:
        """8-bit MACs each bit line performs per output (R'xS')."""
        return self.line_filter_bytes


def map_layer(spec: LayerSpec, geom: CacheGeometry = XEON_E5_35MB) -> MappedLayer:
    if spec.kind in ("maxpool", "avgpool"):
        # pooling maps like conv but with no filters (§IV-D): window elems
        # occupy lines; comparisons happen per line-group of C channels.
        work = spec.window_count
        c_round = min(_next_pow2(max(spec.filter_elems, 1)), MAX_REDUCE_LINES)
        per_array = max(geom.array_cols // c_round, 1)
        parallel = geom.compute_arrays * per_array
        serial = serial_passes_for(work, parallel) if work else 1
        util = work / (serial * parallel) if work else 0.0
        return MappedLayer(
            spec, 1, 1, spec.filter_elems, spec.C or spec.M, c_round,
            c_round, per_array, parallel, serial, util,
        )

    f = spec.filter_elems
    if f > MAX_FILTER_BYTES_PER_LINE:
        split = math.ceil(f / MAX_FILTER_BYTES_PER_LINE)
        line_bytes = math.ceil(f / split)
        pack = 1
        eff_c = spec.C * split
    elif f == 1:
        split = 1
        pack = min(MAX_PACK_BYTES, max(spec.C, 1))
        line_bytes = pack
        eff_c = math.ceil(spec.C / pack)
    else:
        split, pack, line_bytes, eff_c = 1, 1, f, spec.C

    c_round = _next_pow2(max(eff_c, 1))
    if c_round > MAX_REDUCE_LINES:
        raise ValueError(
            f"{spec.name}: {c_round} reduce lines exceed the 2-array sense-amp "
            f"domain; increase packing"
        )

    if c_round <= geom.array_cols:
        # §IV-B: uniformity over utilization — every array holds the *same*
        # set of (distinct-M) filters, so slots beyond M stay idle.
        per_array = min(geom.array_cols // c_round, spec.M)
    else:  # one filter spans two arrays sharing sense amps
        per_array = geom.array_cols / c_round  # 0.5

    parallel = int(geom.compute_arrays * per_array)
    # degenerate specs (conv_count == 0) still map to one idle pass
    serial = serial_passes_for(spec.conv_count, parallel) or 1
    util = spec.conv_count / (serial * parallel)
    return MappedLayer(
        spec, split, pack, line_bytes, eff_c, c_round,
        c_round, per_array, parallel, serial, util,
    )


def check_wordline_budget(m: MappedLayer, geom: CacheGeometry = XEON_E5_35MB) -> int:
    """Word lines used by one bit line's working set (Figure 10): filter +
    streamed input + 3B partial sum + 2B scratch.  Returns free lines
    (>=0 required; the slack stores outputs + reused inputs).

    Consulted by the conv tiler (core/nc_layers.py) before any lanes are
    allocated: a layer that overflows the budget raises here, with the
    offending spec, instead of silently over-allocating word lines the
    modeled array does not have."""
    filt = m.line_filter_bytes * 8
    inp = 8 if m.pack_factor > 1 else m.line_filter_bytes * 8  # §IV-A: 1x1 streams 1B
    used = filt + inp + 3 * 8 + 2 * 8
    free = geom.array_rows - used
    if free < 0:
        raise ValueError(
            f"word-line budget exceeded: {used} lines needed, {geom.array_rows} "
            f"per array ({geom.name}); split the filter further or shrink the "
            f"working set — offending layer: {m.spec}")
    return free


def map_network(
    specs: Iterable[LayerSpec], geom: CacheGeometry = XEON_E5_35MB
) -> list[MappedLayer]:
    mapped = [map_layer(s, geom) for s in specs]
    for m in mapped:
        if m.spec.kind in ("conv", "fc"):
            check_wordline_budget(m, geom)
    return mapped
