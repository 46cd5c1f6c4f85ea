"""Neural Cache cycle/energy/data-movement simulator (paper §V-§VI).

Deterministic performance model with two ingredient classes:

MECHANISTIC (derived, no fitting):
  * the execution plan (core/schedule.py) — filters/array, parallel convs,
    serial passes, spill decisions; the SAME :class:`NetworkSchedule` the
    packed-engine emulation executes, so modeled and emulated runs agree
    on residency by construction (mapping validated against the paper's
    two worked examples),
  * per-conv compute cycles: ``mac8 * macs_per_line + red_step * log2(C')``
    — reproduces the paper's 2784 cycles/conv for Conv2d_2b exactly,
  * byte counts for filters / inputs / outputs from layer geometry,
  * batching model: filters loaded once per layer per batch; outputs of
    early layers spill to DRAM when the batch outgrows the reserved way.

CALIBRATED (constants the paper itself measured with micro-benchmarks and
SPICE, §V — we adopt their published values):
  * mac8 = 236 cycles per 8-bit MAC (§VI-A; first-principles floor is
    mul(8)+add(24) = 127, the rest is tag-load/move orchestration),
  * red_step = 132 cycles per reduction step (660 cycles / 5 steps at C'=32:
    4-byte-segment move+add ~ 97 cycles + 35 measured overhead),
  * effective bandwidths for filter loading (DRAM + ring/bus distribution),
    input streaming and output staging, set from the paper's measured
    latency breakdown (Figure 14) once, then reused for every experiment
    (including the cache-capacity scaling runs of Table IV).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

from repro_torch.core import bitserial as bs
from repro_torch.core.cache_geometry import CacheGeometry, XEON_E5_35MB
from repro_torch.core.mapper import LayerSpec, MappedLayer
from repro_torch.core.schedule import NetworkSchedule, SlicePlan, plan_layer, plan_network

__all__ = ["SimConstants", "LayerResult", "NetworkResult", "simulate_layer",
           "simulate_network", "modeled_layer_cycles", "batch_time_s",
           "throughput", "PAPER"]

MIB = 1 << 20


# Published baseline / headline numbers we validate against (paper §VI).
PAPER = dict(
    nc_latency_ms=4.72,
    cpu_latency_ms=86.4,  # 18.3x
    gpu_latency_ms=36.3,  # 7.7x
    latency_speedup_cpu=18.3,
    latency_speedup_gpu=7.7,
    nc_throughput=604.0,  # dual-socket node, max batch
    cpu_throughput=48.7,  # 604 / 12.4
    gpu_throughput=274.5,  # 604 / 2.2
    nc_energy_j=0.246,
    cpu_energy_j=9.137,
    gpu_energy_j=4.087,
    nc_power_w=52.92,
    cpu_power_w=105.56,
    gpu_power_w=112.87,
    breakdown=dict(filter=0.46, input=0.15, output=0.04, mac=0.20,
                   reduce=0.10, quant=0.05, pool=0.0004),
    capacity_ms={35: 4.72, 45: 4.12, 60: 3.79},
    conv2d_2b_cycles_per_conv=2784,
    conv2d_2b_serial=43,
)


@dataclasses.dataclass(frozen=True)
class SimConstants:
    """Calibrated constants (see module docstring for provenance).

    The word-packed emulation engine (core/bitserial.py) models the same
    hardware with unchanged per-op cycle formulas, so its mechanistic
    costs are hard floors for these calibrated constants —
    :meth:`validate` asserts that invariant and runs once per
    :func:`simulate_network` call."""

    mac8_cycles: int = 236
    reduce_step_cycles: int = 132
    reduce_xstep_cycles: int = 111  # extra per step beyond 5: moves cross the
    #   sense-amp pair boundary once partial sums span >32 lines
    pass_stage_cycles: int = 453  # per serial pass: stage the next window's
    #   input bytes into word lines + move finished outputs out (folded into
    #   the paper's 'MACs' share of Figure 14)
    pool_cmp_cycles: int = 27  # sub(8) + masked copy + tag load
    quant_pass_cycles: int = 3546  # 3 x 32-bit fixed-point multiplies (BN + requant)
    quant_layer_overhead_cycles: int = 2500  # min/max tree + bus reduction
    checksum_pass_cycles: int = 368  # ABFT verify per executed pass:
    #   the checksum column is one extra lane group riding the pass's
    #   MAC (mac8) plus one reduce step to fold its partial sum (236+132);
    #   priced ONLY when the plan sets integrity (exact additive term)
    # effective bandwidths (bytes/s) — measured by the paper's micro-benchmarks
    filter_bw: float = 10.96e9  # DRAM read + ring/bus broadcast + array stores
    input_bw: float = 51.5e9  # reserved-way reads + intra-slice broadcast
    output_bw: float = 61.8e9  # compute arrays -> reserved way
    dram_bw: float = 11.0e9  # batched-output spill/reload
    # energy model
    dram_pj_per_byte: float = 20.0
    bus_pj_per_byte: float = 5.0

    def validate(self) -> "SimConstants":
        """Check the calibrated constants against the emulation's
        mechanistic cycle floors (paper §III formulas)."""
        card = bs.OpCycles(bits=8, acc_bits=24, mac8=self.mac8_cycles)
        assert card.mac_overhead >= 0, (
            f"mac8={self.mac8_cycles} below the mul(8)+add(24) floor "
            f"{card.mac_floor}")
        # one reduce step on a 32-bit partial sum: move(w) + add(w) minimum
        floor = bs.move_cycles(32) + bs.add_cycles(32)
        assert self.reduce_step_cycles >= floor, (
            self.reduce_step_cycles, floor)
        return self

    def scaled_bandwidths(self, geom: CacheGeometry, base: CacheGeometry):
        """Input/output movement parallelizes over slices (§VI-D); filter
        loading is DRAM-bound and does not (filters are replicated)."""
        r = geom.n_slices / base.n_slices
        return dataclasses.replace(self, input_bw=self.input_bw * r,
                                   output_bw=self.output_bw * r)


@dataclasses.dataclass(frozen=True)
class LayerResult:
    spec: LayerSpec
    mapped: MappedLayer
    mac_s: float
    reduce_s: float
    quant_s: float
    pool_s: float
    filter_s: float
    input_s: float
    output_s: float
    compute_cycles_per_pass: float
    energy_j: float
    plan: SlicePlan | None = None  # the schedule entry this result priced
    # §IV-E double buffering (plan.overlap): the first pass's filter columns
    # have no predecessor to hide under
    prologue_s: float = 0.0  # un-hideable load of pass 0's filter columns
    overlap: bool = False
    # integrity: per-pass ABFT checksum verification (plan.integrity).
    # Kept OUT of mac_s/reduce_s so the §IV-E hidden-load credit (capped by
    # mac+reduce) is untouched and the additive-credit invariant is exact.
    integrity_s: float = 0.0
    # compressed residency: the filter-load seconds compression
    # keeps off the §VI-C per-batch load — (dense live-set bytes −
    # compressed bytes) / filter_bw, already inside filter_s because the
    # plan's filter_bytes IS the compressed footprint.  An exact additive
    # credit: dense total_s − compressed total_s == residency_credit_s for
    # overlap-off plans (zero when the plan is uncompressed).
    residency_credit_s: float = 0.0

    @property
    def compute_s(self) -> float:
        return (self.mac_s + self.reduce_s + self.quant_s + self.pool_s
                + self.integrity_s)

    @property
    def total_s(self) -> float:
        return self.compute_s + self.filter_s + self.input_s + self.output_s

    @property
    def hidden_s(self) -> float:
        """Filter-load seconds hidden under MAC+reduce when the plan
        granted §IV-E double buffering — the layer's overlapped filter cost
        is ``prologue + max(filter_s - prologue, mac_s + reduce_s)`` in
        place of the serial ``filter_s + mac_s + reduce_s``, so the credit
        is ``min(filter_s - prologue_s, mac_s + reduce_s)``.

        The cap is ONE image's MAC+reduce even in a batch: layer-serial
        §IV-E streams image 1's pass sequence first, and pass k's columns
        must land before pass k consumes them, so every load has to
        interleave into the FIRST image's passes (images 2..N then run
        fully resident).  The credit is therefore batch-independent, which
        keeps ``batch_time_s`` strictly increasing in the batch.  Zero
        when overlap is off — serial pricing is bit-identical."""
        if not self.overlap:
            return 0.0
        return min(max(self.filter_s - self.prologue_s, 0.0),
                   self.mac_s + self.reduce_s)


def _fresh_input_fraction(spec: LayerSpec) -> float:
    """Input-reuse model (§IV-A): for an RxS window with stride U, (R-U)xS of
    the RxS bytes are reused across consecutive output pixels held in-array
    (e.g. 6 of 9 for 3x3 stride 1)."""
    if spec.filter_elems <= 1:
        return 1.0
    reuse = max(spec.R - spec.stride, 0) / spec.R
    return 1.0 - reuse


def simulate_layer(
    spec: LayerSpec | SlicePlan,
    geom: CacheGeometry = XEON_E5_35MB,
    const: SimConstants = SimConstants(),
) -> LayerResult:
    """Price one layer.  Accepts a raw :class:`LayerSpec` (planned here at
    batch 1) or a :class:`SlicePlan` straight from the schedule — the same
    plan object the packed-engine emulation executes, so residency, pass
    counts and spill decisions are never re-derived."""
    if isinstance(spec, SlicePlan):
        plan = spec
        spec = plan.spec
    else:
        plan = plan_layer(spec, geom)
    m = plan.mapped
    f_hz = geom.compute_freq_hz

    if spec.kind in ("maxpool", "avgpool"):
        # window_size-1 comparisons per window, all lanes in lockstep
        cmps = max(spec.filter_elems - 1, 1)
        pass_cycles = cmps * const.pool_cmp_cycles
        if spec.kind == "avgpool":
            pass_cycles = spec.filter_elems * bs.add_cycles(16) + bs.div_cycles(8)
        pool_s = plan.serial_passes * pass_cycles / f_hz
        input_s = spec.window_count * spec.filter_elems * _fresh_input_fraction(spec) / const.input_bw
        output_s = spec.output_bytes / const.output_bw
        energy = (
            plan.serial_passes * pass_cycles * geom.compute_arrays * m.utilization
            * geom.compute_energy_pj * 1e-12
        )
        return LayerResult(spec, m, 0.0, 0.0, 0.0, pool_s, 0.0, input_s,
                           output_s, pass_cycles, energy, plan)

    # ---- convolution / fc -------------------------------------------------
    mac_cycles = const.mac8_cycles * m.macs_per_line
    steps = m.reduction_steps
    red_cycles = const.reduce_step_cycles * steps + const.reduce_xstep_cycles * max(steps - 5, 0)
    per_conv = mac_cycles + red_cycles

    # sparsity-aware: the plan may have dropped serialized passes whose
    # filters are all zero (plan.skipped_passes); dense plans price the
    # identical expression with a zero credit — bit-identical numbers.
    passes = plan.executed_passes
    mac_s = passes * (mac_cycles + const.pass_stage_cycles) / f_hz
    reduce_s = passes * red_cycles / f_hz

    # requantization (+folded BN) applies to output elements in lockstep
    # across lanes: once per lane-full of outputs (the plan's quant
    # passes), plus the per-layer min/max tree + inter-array bus reduction
    # (§IV-D; the calibrated constant — the schedule's mechanistic
    # ``minmax_cycles`` is the emulation-side per-tensor tree).
    quant_s = (plan.quant_passes * const.quant_pass_cycles
               + const.quant_layer_overhead_cycles) / f_hz

    # §VI-C residency: filters load once per layer per batch
    filter_bytes = plan.filter_bytes
    filter_s = filter_bytes / const.filter_bw
    input_stream = spec.conv_count * spec.filter_elems * _fresh_input_fraction(spec)
    input_s = input_stream / const.input_bw
    output_s = spec.output_bytes / const.output_bw

    compute_cycles = passes * (per_conv + const.pass_stage_cycles) + quant_s * f_hz
    active = geom.compute_arrays * m.utilization
    energy = (
        compute_cycles * active * geom.compute_energy_pj * 1e-12
        + filter_bytes * (const.dram_pj_per_byte + const.bus_pj_per_byte) * 1e-12
        + (input_stream + spec.output_bytes) * const.bus_pj_per_byte * 1e-12
    )
    # §IV-E double buffering: pass k+1's filter columns stream while pass
    # k's MAC+reduce runs; only the first pass's chunk is un-hideable
    overlap = plan.overlap
    prologue_s = (plan.filter_bytes_per_pass / const.filter_bw
                  if overlap else 0.0)
    # integrity: one checksum verification per executed pass, an
    # exact additive term (zero — bit-identical pricing — when off)
    integrity_s = (passes * const.checksum_pass_cycles / f_hz
                   if plan.integrity else 0.0)
    return LayerResult(spec, m, mac_s, reduce_s, quant_s, 0.0, filter_s,
                       input_s, output_s, per_conv, energy, plan,
                       prologue_s=prologue_s, overlap=overlap,
                       integrity_s=integrity_s,
                       residency_credit_s=(plan.residency_credit_bytes
                                           / const.filter_bw))


def modeled_layer_cycles(
    spec: LayerSpec | SlicePlan,
    geom: CacheGeometry = XEON_E5_35MB,
    const: SimConstants = SimConstants(),
) -> dict:
    """Paper-style modeled compute cycles for one layer: the mapper's
    serialized passes times the per-pass cost (MAC + log-tree + staging).

    This is the analytic counterpart of the emulation's arithmetic cycle
    count (core/nc_layers.py): the emulation charges the §III formulas per
    lane group, the model charges the calibrated per-pass constants per
    serialized pass — models/inception.py's ``nc_forward`` reports both
    side by side.

    Accepts a :class:`SlicePlan` for sparse plans: ``total_cycles`` then
    covers only the executed passes and ``skip_credit_cycles`` is the
    exact credit — ``dense_total - sparse_total == skip_credit_cycles``
    holds to the cycle (same per-pass cost, the occupancy never changes
    the mapped layout).

    Overlap (§IV-E double buffering) never changes the compute cycles —
    it re-times the filter LOAD against them — so ``total_cycles`` is
    overlap-invariant; the hidden-load credit is reported in seconds
    (``hidden_s``, with the un-hideable ``prologue_s``) and
    ``overlapped_total_s = total_s - hidden_s`` is the layer's §IV-E
    double-buffered wall time (== ``total_s`` when overlap is off).

    Integrity is the same additive idiom: when the plan sets
    ``integrity``, each executed pass also pays ``checksum_pass_cycles``
    (``integrity_cycles`` in total, folded into ``total_cycles`` and the
    skip credit so EVERY credit identity stays exact), and
    ``reexec_pass_cycles`` is the price of re-running one pass after a
    detected fault — the engine multiplies it by its measured re-execution
    count.  Integrity-off plans price bit-identically (both terms zero)."""
    res = simulate_layer(spec, geom, const)
    per_pass = res.compute_cycles_per_pass
    passes = (res.plan.serial_passes if res.plan is not None
              else res.mapped.serial_passes)
    skipped = res.plan.skipped_passes if res.plan is not None else 0
    cs_per_pass = (const.checksum_pass_cycles
                   if res.plan is not None and res.plan.integrity else 0)
    return dict(
        per_pass_cycles=per_pass,
        serial_passes=passes,
        skipped_passes=skipped,
        skip_credit_cycles=(per_pass + cs_per_pass) * skipped,
        total_cycles=(per_pass + cs_per_pass) * (passes - skipped),
        integrity_cycles=cs_per_pass * (passes - skipped),
        reexec_pass_cycles=per_pass + cs_per_pass,
        compute_s=res.compute_s,
        total_s=res.total_s,
        overlap=res.overlap,
        prologue_s=res.prologue_s,
        hidden_s=res.hidden_s,
        overlapped_total_s=res.total_s - res.hidden_s,
        integrity_s=res.integrity_s,
        residency_credit_s=res.residency_credit_s,
    )


@dataclasses.dataclass(frozen=True)
class NetworkResult:
    layers: tuple[LayerResult, ...]
    geom: CacheGeometry
    const: SimConstants
    schedule: NetworkSchedule | None = None  # the plan this result priced

    @property
    def filter_s(self) -> float:
        return sum(l.filter_s for l in self.layers)

    @property
    def input_s(self) -> float:
        return sum(l.input_s for l in self.layers)

    @property
    def output_s(self) -> float:
        return sum(l.output_s for l in self.layers)

    @property
    def mac_s(self) -> float:
        return sum(l.mac_s for l in self.layers)

    @property
    def reduce_s(self) -> float:
        return sum(l.reduce_s for l in self.layers)

    @property
    def quant_s(self) -> float:
        return sum(l.quant_s for l in self.layers)

    @property
    def pool_s(self) -> float:
        return sum(l.pool_s for l in self.layers)

    @property
    def integrity_s(self) -> float:
        """per-pass checksum verification, summed over layers — the
        network's exact additive integrity cost (zero when off)."""
        return sum(l.integrity_s for l in self.layers)

    @property
    def residency_credit_s(self) -> float:
        """compressed residency: filter-load seconds compression
        keeps off the per-batch load, summed over layers.  Batch-
        independent (filters load once per batch), so for overlap-off
        schedules ``batch_time_s(dense, N) - batch_time_s(compressed, N)
        == residency_credit_s`` exactly, for every N (zero when off)."""
        return sum(l.residency_credit_s for l in self.layers)

    @property
    def compute_s(self) -> float:
        return (self.mac_s + self.reduce_s + self.quant_s + self.pool_s
                + self.integrity_s)

    @property
    def marginal_s(self) -> float:
        """Per-image time with filters resident (batched steady state)."""
        return self.compute_s + self.input_s + self.output_s

    @property
    def hidden_s(self) -> float:
        """Filter-load seconds hidden under MAC+reduce across the network
        (§IV-E double buffering; zero for overlap-off schedules).
        Batch-independent — see :attr:`LayerResult.hidden_s`."""
        return sum(l.hidden_s for l in self.layers)

    @property
    def latency_s(self) -> float:
        return self.filter_s + self.marginal_s

    @property
    def overlapped_latency_s(self) -> float:
        """Single-image latency with the schedule's §IV-E double buffering
        applied: per layer, ``prologue + max(load_rest, mac+reduce)``
        instead of ``load + mac + reduce``.  Equals :attr:`latency_s` when
        overlap is off."""
        return self.latency_s - self.hidden_s

    @property
    def energy_j(self) -> float:
        return sum(l.energy_j for l in self.layers)

    @property
    def power_w(self) -> float:
        return self.energy_j / self.latency_s

    def breakdown(self) -> dict[str, float]:
        t = self.latency_s
        return dict(
            filter=self.filter_s / t, input=self.input_s / t,
            output=self.output_s / t, mac=self.mac_s / t,
            reduce=self.reduce_s / t, quant=self.quant_s / t,
            pool=self.pool_s / t,
        )

    @property
    def filter_bytes_loaded(self) -> int:
        """Filter bytes loaded per batch — once per layer, independent of
        batch size, because filters stay resident while the batch streams
        (§VI-C; the schedule's residency accounting)."""
        if self.schedule is not None:
            return self.schedule.filter_bytes_loaded
        return sum(l.spec.filter_bytes for l in self.layers)

    def spill_s_per_image(self) -> float:
        """Batched mode: a layer's batch-wide output set must stay resident
        until the next layer consumes it; when it exceeds the reserved way it
        round-trips DRAM (§IV-E: 'the first five [layers]' for Inception v3).
        The spill decision lives in the schedule (one source of truth); a
        hand-built NetworkResult without one falls back to the same rule."""
        if self.schedule is not None:
            return self.schedule.spill_bytes_per_image / self.const.dram_bw
        cap = self.geom.io_way_bytes / 2  # staging holds inputs + outputs
        spill = sum(2 * l.spec.output_bytes for l in self.layers
                    if l.spec.output_bytes > cap / 2)
        return spill / self.const.dram_bw


def simulate_network(
    specs: Sequence[LayerSpec] | NetworkSchedule,
    geom: CacheGeometry = XEON_E5_35MB,
    const: SimConstants = SimConstants(),
    base_geom: CacheGeometry = XEON_E5_35MB,
) -> NetworkResult:
    """Price a network.  Accepts the layer specs (planned here at batch 1)
    or a ready :class:`NetworkSchedule` — e.g. the very object a batched
    ``nc_forward``/serving run executed — so residency, spill and pass
    counts come from one plan."""
    if isinstance(specs, NetworkSchedule):
        schedule = specs
        geom = schedule.geom
    else:
        schedule = plan_network(specs, geom, batch=1)
    const = const.validate().scaled_bandwidths(geom, base_geom)
    return NetworkResult(
        tuple(simulate_layer(p, geom, const) for p in schedule.layers),
        geom, const, schedule)


def batch_time_s(result: NetworkResult, batch: int) -> float:
    """Modeled time to process ONE admitted batch of ``batch`` images,
    layer-serially (§IV-E):

    total(N) = filter_load + N * marginal + N * spill - hidden  (spill only
    when the batch outgrows the reserved way, i.e. N >= 2; ``hidden`` is
    the schedule's §IV-E double-buffering credit — per layer the filter
    cost collapses from ``load + mac + reduce`` to
    ``prologue + max(load_rest, mac + reduce)``, and the credit is
    batch-independent because every load must land inside the FIRST
    image's pass sequence — see :attr:`LayerResult.hidden_s`).

    This is the per-batch latency the serving admission policy predicts
    against (core/slo.py): strictly increasing in ``batch`` (marginal and
    spill are per-image costs, the hidden credit a constant), with the
    filter load amortizing — the latency/throughput trade the SLO knob
    walks.  Overlap-off schedules price bit-identically to the serial
    serial model (``hidden == 0``).  ``throughput`` is its reciprocal
    view."""
    spill = result.spill_s_per_image() if batch > 1 else 0.0
    return result.filter_s + batch * (result.marginal_s + spill) - result.hidden_s


def throughput(result: NetworkResult, batch: int, sockets: int = 2) -> float:
    """Inferences/s for a batch processed layer-serially (§IV-E): the
    batch count over :func:`batch_time_s`, scaled by ``sockets``."""
    return sockets * batch / batch_time_s(result, batch)
