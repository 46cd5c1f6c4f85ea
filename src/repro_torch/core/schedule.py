"""Batched slice-scheduler: ONE plan object from mapper to packed engine to
serving.

(PyTorch port: a copy of ``repro.core.schedule`` on top of the port's own
``bitserial`` and ``backends``.  Plans must equal the reference's field for
field, so every plan field — occupancy, overlap, integrity, compression and
the backend pin — is kept even where this package does not execute it yet.)

The paper's headline throughput comes from *batch scheduling*, not raw MACs:
filters stay resident in the compute ways while a batch of images streams
through the reserved I/O way (§VI-C), and even the quantization min/max
reduction stays in-cache (§IV-D).  This module turns the mapper's layout
(core/mapper.py) plus a batch size into an explicit, shared execution plan:

* :class:`SlicePlan` — one layer's plan.  Field ↔ paper-section map:

  ===================  =====================================================
  field                paper
  ===================  =====================================================
  ``mapped``           §IV-A/B filter splitting/packing/replication — the
                       residency layout (filters per array, parallel convs)
  ``filter_bytes``     §VI-C: filter bytes loaded ONCE per layer per batch
                       (filters are resident while the batch streams)
  ``serial_passes``    §IV-B serialized passes per image
  ``total_passes``     §IV-E layer-serial batching: passes × batch
  ``tile_rows`` /      packed-engine batch tiling: (image, pixel) rows ×
  ``tile_filters``     filters per engine tile, bounded by the cache
                       geometry's bit lines (``geom.compute_slots``)
  ``batch_tile``       whole images folded into one MAC+reduce tile
  ``spill_to_dram``    §IV-E: batch-wide outputs that outgrow the reserved
                       I/O way round-trip DRAM (the simulator's batching
                       model, now decided in one place)
  ``quant_passes``     §IV-D lockstep fixed-point requant passes per image
  ``minmax_cycles``    §IV-D in-cache min/max log tree per image (the two
                       dynamic-range scalars are all that leaves the cache)
  ===================  =====================================================

* :class:`NetworkSchedule` — the per-layer plans for a whole network at one
  batch size, with the aggregate residency/spill accounting.

Sparsity-aware scheduling (occupancy metadata + skip credits)
-------------------------------------------------------------
Value sparsity is a first-class *input* to the plan, not an opportunistic
engine trick.  A :class:`LayerOccupancy` carries what the pack-time scan
(:func:`bitserial.filter_occupancy`, run over the quantized filter rows)
detected, plus a ReLU-chain activation-sparsity estimate threaded from the
model definition (models/inception.py):

* ``zero_filters`` — filters whose every quantized weight equals the zero
  point.  Their dequantized value is exactly 0, so their whole serialized
  passes carry no information: :func:`plan_layer` re-runs the mapper's ONE
  serialization rule (``mapper.serial_passes_for``) over the *live* conv
  count and records the difference as ``SlicePlan.skipped_passes`` — the
  skipped-pass cycle credit the simulator prices (per-pass cycles x
  skipped passes, exactly) and the packed engine executes (the pruned pass
  list: zero-filter outputs are filled from the affine identity
  ``zw * sum(x)``, bit-identical to computing them).  Pruned filters are
  also not loaded: ``filter_bytes`` shrinks to the live set (§VI-C
  residency of an EIE-style pruned network).
* ``dead_planes`` — filter bit planes with no set bit; the ``walk``
  multiply (the reference's host) elides those shifted-add steps
  (bitserial ``SKIP_STATS.planes_skipped``)
  with results unchanged.  Advisory for the model: per-plane elision never
  changes modeled cycles (the SRAM clocks every bit-slice of the passes it
  *does* run).
* ``activation_sparsity`` — the estimated fraction of exactly-zero input
  activations (ReLU chains make post-activation zeros exact in the uint8
  resident format).  An estimate can never earn an exact cycle credit, so
  it stays advisory: it sizes the EIE-style zero-operand word elision the
  ``walk`` engine already performs and is reported alongside the measured
  zero-lane counts.

Only the deterministic filter occupancy changes numbers, and only when
present: ``occupancy=None`` (or zero detected sparsity) plans are
field-for-field identical to dense plans, and the simulator's dense
outputs stay bit-identical.  ``stream_batch_limit`` is intentionally
pruning-independent (activations stream at full width either way) —
until compression opts the plan into the tighter staging
accounting that lets shrinking residency raise the ceiling (see
``NetworkSchedule.stream_batch_limit``).

Consumers (the "one source of truth" contract):

* core/nc_layers.py tiles its packed MAC+reduce work with the plan's
  ``tile_rows``/``tile_filters`` (batch folded into the packed lane axis)
  and executes only the plan's live filter columns,
* core/simulator.py prices the SAME plan instead of re-deriving residency,
  so modeled and emulated cycles agree on the layout by construction
  (skipped-pass credits included),
* models/inception.py executes the schedule end to end (``nc_forward``),
* launch/serve.py admits request batches sized to the schedule, and
* core/slo.py predicts per-batch serving latency from it (the SLO
  admission policy's control input; ``stream_batch_limit`` is its hard
  batch cap).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Sequence

import torch

from repro_torch.core import bitserial as bs
from repro_torch.core.cache_geometry import CacheGeometry, XEON_E5_35MB
from repro_torch.core.mapper import (LayerSpec, MappedLayer, check_wordline_budget,
                               compressed_filter_bytes, map_layer,
                               pass_filter_bytes, serial_passes_for)

__all__ = ["LayerOccupancy", "PassStage", "SlicePlan", "NetworkSchedule",
           "conv_tiles", "plan_layer", "plan_network", "prune_occupancy"]

ACC_BITS = 32  # reserved-way staging width of a conv partial sum


def conv_tiles(E: int, F: int, M: int, K: int,
               geom: CacheGeometry = XEON_E5_35MB,
               batch: int = 1,
               tile_pixels: int | None = None,
               tile_filters: int | None = None) -> tuple[int, int]:
    """Tile sizes for the packed engine: (rows, filters) per tile.

    A row is one (image, output pixel) pair — the batch is folded into the
    row axis, so one MAC+reduce tile serves rows from several images when
    they fit.  A tile's bit-line count (rows × P padded lanes × filters)
    is bounded by the cache's compute slots; whole-image row tiles are
    preferred.  ``tile_pixels``/``tile_filters`` are caller overrides
    (clamped to the actual work)."""
    R = batch * E * F
    P = bs._row_layout(K)[0]
    cap = max(geom.compute_slots, P)
    # clamp caller-supplied sizes first so the derived dimension is sized
    # for the effective tile, not an oversized request
    if tile_pixels is not None:
        tile_pixels = min(tile_pixels, R)
    if tile_filters is not None:
        tile_filters = min(tile_filters, M)
    if tile_pixels is None and tile_filters is None:
        if P * R * M <= cap:
            return R, M
        tf = cap // (P * R)
        if tf >= 1:
            return R, int(tf)
        return max(1, cap // P), 1
    if tile_filters is None:
        tile_filters = max(1, min(M, cap // (P * tile_pixels)))
    if tile_pixels is None:
        tile_pixels = max(1, min(R, cap // (P * tile_filters)))
    return min(tile_pixels, R), min(tile_filters, M)


@dataclasses.dataclass(frozen=True)
class LayerOccupancy:
    """Per-layer value-sparsity metadata (see the module docstring).

    ``zero_filters`` holds the sorted indices of filters whose every
    quantized weight equals the zero point — the deterministic sparsity
    that earns skipped-pass credits.  ``dead_planes``/``plane_bits`` and
    ``activation_sparsity`` are advisory (engine-side elision and
    reporting only)."""

    total_filters: int
    zero_filters: tuple[int, ...] = ()
    plane_bits: int = 8
    dead_planes: int = 0
    activation_sparsity: float = 0.0  # est. zero fraction of INPUT lanes
    # MEASURED live output lanes per image (warmup re-planning):
    # None = unmeasured, the estimate above stays advisory.  When set, the
    # §IV-D requant pass count shrinks to the live output set — zero output
    # lanes requantize to the analytically-known zero point, the same
    # affine-identity argument that lets zero-filter passes skip.
    live_outputs: int | None = None

    def __post_init__(self):
        zf = tuple(sorted(int(i) for i in set(self.zero_filters)))
        object.__setattr__(self, "zero_filters", zf)
        if zf and not (0 <= zf[0] and zf[-1] < self.total_filters):
            raise ValueError(
                f"zero filter indices {zf[0]}..{zf[-1]} out of range for "
                f"{self.total_filters} filters")

    @property
    def n_zero(self) -> int:
        return len(self.zero_filters)

    @property
    def n_live(self) -> int:
        return self.total_filters - self.n_zero

    @property
    def zero_fraction(self) -> float:
        return self.n_zero / max(self.total_filters, 1)

    @classmethod
    def from_filter_rows(cls, rows, n_bits: int, zero_point: int = 0,
                         activation_sparsity: float = 0.0) -> "LayerOccupancy":
        """Build from quantized filter rows ``(M, K)`` via the pack-time
        scan (:func:`bitserial.filter_occupancy`)."""
        rows = torch.as_tensor(rows)
        zero_mask, plane_live = bs.filter_occupancy(rows, n_bits, zero_point)
        return cls(
            total_filters=int(rows.shape[0]),
            zero_filters=tuple(torch.nonzero(zero_mask).flatten().tolist()),
            plane_bits=int(n_bits),
            dead_planes=int((~plane_live).sum()),
            activation_sparsity=float(activation_sparsity),
        )


@dataclasses.dataclass(frozen=True)
class PassStage:
    """One serialized pass split into its explicit (load, compute) stages.

    ``load_bytes`` is the slice of the layer's filter columns streamed into
    the reserved I/O way for THIS pass; ``overlapped`` marks loads that
    stream while the PREVIOUS pass's MAC+reduce runs in the compute ways
    (§IV-E double buffering).  The first stage's load is the prologue — it
    has no predecessor to hide under, so it is never overlapped.  Quant
    passes and the min/max reduction are not stages: they stay on the
    serial tail (§IV-D lockstep needs the full output set staged)."""

    index: int  # serialized pass index per image, 0-based
    load_bytes: int  # filter bytes streamed for this pass's columns
    overlapped: bool  # load hidden under pass index-1's MAC+reduce


@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """One layer's execution plan (see the module docstring field map).

    Invariants (asserted by tests/test_schedule.py and
    tests/test_sparsity.py — discoverable here so you don't have to read
    them):

    * **Credit exactness** — the simulator prices ``skipped_passes`` as
      an exact per-pass credit: for any geometry and batch,
      ``dense.total_cycles - sparse.total_cycles ==
      sparse.skip_credit_cycles`` holds to the cycle
      (``simulator.modeled_layer_cycles``), because occupancy never
      changes the mapped layout — only the executed pass count.
    * **Dense bit-identity** — a plan built with ``occupancy=None`` (or
      with zero detected sparsity) is field-for-field identical to the
      dense plan, and every consumer's outputs (engine logits, simulator
      numbers) are bit-identical to pre-sparsity behavior.
    * ``executed_passes == serial_passes - skipped_passes`` is what the
      engine runs per image; pruned filters also leave ``filter_bytes``
      (the §VI-C residency of the live set).
    * The tile bound ``row_bits * tile_rows * tile_filters <=
      geom.compute_slots`` always holds (batch folded into the row
      axis)."""

    spec: LayerSpec
    mapped: MappedLayer
    batch: int
    # packed-engine tiling (consumed by core/nc_layers.py)
    K: int  # reduce lanes per dot row (R*S*C; window elems for pools)
    row_bits: int  # P = next_pow2(K): padded bit positions per row
    tile_rows: int  # (image, pixel) rows per engine tile
    tile_filters: int
    batch_tile: int  # whole images folded into one engine tile
    tiles: int  # engine tiles covering the whole batch
    # residency / movement (§IV-A/B, §VI-C)
    filter_bytes: int  # loaded once per layer per BATCH (filters resident)
    input_bytes_per_image: int
    output_bytes_per_image: int
    serial_passes: int  # per image (mapper §IV-B)
    total_passes: int  # serial_passes * batch (§IV-E layer-serial)
    spill_to_dram: bool  # batch outputs overflow the reserved I/O way
    spill_bytes_per_image: int  # dump + reload when spilling
    # §IV-D in-cache quantization
    quant_passes: int  # lockstep requant passes per image
    minmax_cycles: int  # in-cache min/max log tree per image
    # value sparsity (see "Sparsity-aware scheduling" in the module docs);
    # occupancy=None <=> dense plan, numbers above untouched
    occupancy: LayerOccupancy | None = None
    skipped_passes: int = 0  # serialized passes dropped (zero filters), /image
    # §IV-E double buffering (see PassStage); overlap=False plans and their
    # consumers are bit-identical to the strictly serial behavior
    filter_bytes_per_pass: int = 0  # ONE pass's filter columns (live set)
    overlap: bool = False  # pass k+1's load streams under pass k's compute
    # integrity: ABFT checksum columns verified after every pass's
    # MAC+reduce; integrity=False plans and their consumers are
    # bit-identical to the unchecked behavior (same invariant idiom as
    # occupancy/overlap above)
    integrity: bool = False  # verify checksum columns after each pass
    # slices quarantined by repeated integrity failures: the pass list is
    # re-serialized over the surviving slices (the fault path's analogue of
    # the pruned-pass machinery); () <=> full slice pool, numbers untouched
    quarantined_slices: tuple[int, ...] = ()
    # compressed residency: filters stored CSR-style per bit plane
    # (bitserial.CompressedPlanes) — ``filter_bytes`` above is then the
    # compressed footprint (mapper.compressed_filter_bytes over the live
    # set) and ``dense_filter_bytes`` keeps the uncompressed residency the
    # simulator's exact credit is measured against.  compressed=False plans
    # and their consumers are bit-identical to the uncompressed behavior
    # (same invariant idiom as occupancy/overlap/integrity above).
    compressed: bool = False
    dense_filter_bytes: int = 0  # uncompressed live-set residency (credit ref)
    # backend pin: the registered execution backend
    # (core/backends.py) the engine must run this plan's tiles through;
    # None leaves the choice to the call site / NC_BACKEND environment.
    # Backends re-time execution only — every field above, and every
    # modeled cycle derived from them, is backend-independent.
    backend: str | None = None

    @property
    def is_compute(self) -> bool:
        return self.spec.kind in ("conv", "fc")

    @property
    def executed_passes(self) -> int:
        """Serialized passes the engine actually runs per image: the dense
        §IV-B count minus the skipped-pass credit."""
        return self.serial_passes - self.skipped_passes

    @property
    def residency_credit_bytes(self) -> int:
        """Filter bytes compression keeps out of the §VI-C per-batch load:
        uncompressed live-set residency minus the compressed footprint.
        The simulator prices exactly this at filter bandwidth (and the
        credit can be slightly negative for a dense, unpruned layer —
        the CSR index is honest overhead)."""
        return (self.dense_filter_bytes - self.filter_bytes
                if self.compressed else 0)

    def pass_stages(self) -> tuple[PassStage, ...]:
        """The layer's serialized passes as explicit (load, compute) stages
        — one :class:`PassStage` per executed pass, loads chunked by the
        mapper's ONE streaming rule (``mapper.pass_filter_bytes``) so they
        sum to ``filter_bytes`` exactly.  Stage 0 is the un-hideable
        prologue; stages 1+ are overlapped iff the plan decided overlap is
        legal.  Pool layers (no filters, no passes to buffer) have no
        stages."""
        if not self.is_compute:
            return ()
        chunk = self.filter_bytes_per_pass
        stages = []
        for k in range(self.executed_passes):
            load = max(0, min(chunk, self.filter_bytes - k * chunk))
            stages.append(PassStage(index=k, load_bytes=load,
                                    overlapped=self.overlap and k > 0))
        return tuple(stages)


def plan_layer(spec: LayerSpec,
               geom: CacheGeometry = XEON_E5_35MB,
               batch: int = 1,
               *,
               tile_pixels: int | None = None,
               tile_filters: int | None = None,
               occupancy: LayerOccupancy | None = None,
               overlap: bool = False,
               integrity: bool = False,
               quarantined_slices: Sequence[int] = (),
               compressed: bool = False,
               backend: str | None = None) -> SlicePlan:
    """Map one layer (§IV-A/B) and schedule it for ``batch`` images.

    ``occupancy`` makes value sparsity an input to the plan: passes whose
    filters are all zero are dropped (``skipped_passes``, priced as an
    exact cycle credit by the simulator) and pruned filters are not loaded
    (``filter_bytes`` shrinks to the live set).  ``occupancy=None`` plans
    are field-for-field identical to the dense plan.

    ``overlap=True`` *requests* §IV-E double buffering: stream pass k+1's
    filter columns into the reserved I/O way while pass k's MAC+reduce
    runs.  The per-layer decision (``SlicePlan.overlap``) grants it only
    when it is legal — the layer is multi-pass compute with filters to
    load, and ONE pass's columns (``mapper.pass_filter_bytes`` over the
    live pass sequence) fit the I/O way's output half alongside the staged
    per-image outputs.  The headroom reuses the §IV-E spill accounting:
    spilling layers stage outputs in DRAM, so the full output half is
    prefetch headroom; non-spilling layers keep outputs staged and the
    prefetch buffer gets what is left.  Quant passes and min/max always
    stay on the serial tail.

    Invariants the tests pin down (tests/test_sparsity.py):

    * the skipped-pass count is *monotone* in sparsity — more zero
      filters never skip fewer passes — and comes from re-running the
      mapper's ONE serialization rule (``serial_passes_for``) over the
      live conv count, never from ad-hoc arithmetic here,
    * an occupancy whose ``total_filters`` disagrees with the spec
      raises (over-claiming sparsity is an error, not an optimization),
    * zero detected sparsity (``occupancy`` with no zero filters) plans
      structurally equal to ``occupancy=None``.

    ``integrity=True`` appends ABFT checksum columns to each pass's packed
    filter block, verified after its MAC+reduce (the fault path of
    ``core/faults.py``); the simulator prices the verification as an exact
    additive term and ``integrity=False`` plans are field-for-field
    identical to unchecked ones.  ``quarantined_slices`` removes slices
    lost to repeated integrity failures from the §IV-B replication pool:
    the SAME serialization rule re-runs over the surviving parallelism, so
    pass counts (and their pricing) grow honestly while the layout stays
    the mapper's.

    ``compressed=True`` stores the live filter set CSR-style per bit plane:
    ``filter_bytes`` becomes the compressed footprint —
    ``mapper.compressed_filter_bytes`` over the live-set residency, live
    bit planes only plus the per-plane live-column index — and
    ``dense_filter_bytes`` records the uncompressed residency so the
    simulator can price the delta as an exact additive credit.
    ``filter_bytes_per_pass`` (and with it the §IV-E overlap headroom
    check) derives from the compressed bytes through the SAME
    ``mapper.pass_filter_bytes`` rule, so streaming, overlap legality and
    pricing all shrink consistently.  ``compressed=False`` plans are
    field-for-field identical to uncompressed ones.

    ``backend`` pins the execution backend: a name from the
    registry in ``core/backends.py`` (validated here — an unknown name
    raises listing the registered set) that the packed engine must run
    this plan's tiles through.  Like every other plan decision it rides
    the plan to the call site: ``nc_conv2d``/``nc_fc`` adopt it when no
    explicit ``engine=`` is given, and an explicit engine that
    contradicts it raises.  Backends never change a plan's numbers —
    every other field is backend-independent."""
    if backend is not None:
        from repro_torch.core import backends as _backends
        backend = _backends.get_backend(backend,
                                        source="plan_layer(backend=)").name
    mapped = map_layer(spec, geom)
    E = F = spec.E
    skipped = 0
    quarantined = tuple(sorted(set(int(s) for s in quarantined_slices)))
    parallel = mapped.parallel_convs
    base_serial = mapped.serial_passes
    if quarantined and spec.kind in ("conv", "fc"):
        if not all(0 <= s < geom.n_slices for s in quarantined):
            raise ValueError(
                f"{spec.name}: quarantined slices {quarantined} out of range "
                f"for {geom.n_slices}-slice geometry")
        # §IV-B replication is uniform across slices, so losing a slice
        # scales the parallel conv pool proportionally; the surviving pool
        # feeds the mapper's ONE serialization rule
        live_slices = max(geom.n_slices - len(quarantined), 1)
        parallel = max(1, mapped.parallel_convs * live_slices
                       // geom.n_slices)
        base_serial = serial_passes_for(spec.conv_count, parallel) or 1
    if spec.kind in ("conv", "fc"):
        check_wordline_budget(mapped, geom)
        K = spec.R * spec.S * spec.C
        tr, tf = conv_tiles(E, F, spec.M, K, geom, batch,
                            tile_pixels, tile_filters)
        pixels = max(E * F, 1)
        batch_tile = max(1, min(batch, tr // pixels))
        tiles = (math.ceil(batch * pixels / tr)
                 * math.ceil(spec.M / max(tf, 1)))
        filter_bytes = spec.filter_bytes
        quant_passes = math.ceil(spec.output_bytes / geom.compute_slots)
        minmax = bs.minmax_cycles(spec.output_bytes, ACC_BITS)
        if occupancy is not None:
            if occupancy.total_filters != spec.M:
                raise ValueError(
                    f"{spec.name}: occupancy covers {occupancy.total_filters} "
                    f"filters, layer has {spec.M}")
            # the mapper's ONE serialization rule over the LIVE conv count:
            # zero filters contribute no serialized work (their outputs are
            # the analytically-known affine constant)
            live_passes = serial_passes_for(
                occupancy.n_live * E * F, parallel)
            skipped = base_serial - live_passes
            filter_bytes = spec.R * spec.S * spec.C * occupancy.n_live
            if occupancy.live_outputs is not None:
                # warmup-measured live output lanes: the §IV-D
                # lockstep requant runs over the live set only — zero
                # lanes fill with the analytically-known zero point
                live_out = max(0, min(int(occupancy.live_outputs),
                                      spec.output_bytes))
                quant_passes = math.ceil(live_out / geom.compute_slots)
    else:  # pooling: no filters, no requantization — comparisons in place
        K = spec.filter_elems
        tr, tf = batch * E * F, 1
        batch_tile = batch
        tiles = 1
        filter_bytes = 0
        quant_passes = 0
        minmax = 0
    compressed = bool(compressed) and spec.kind in ("conv", "fc")
    dense_resident = filter_bytes if compressed else 0
    if compressed:
        # CSR bit-plane residency: the ONE compressed-residency
        # rule — everything downstream (per-pass streaming, overlap
        # headroom, the simulator's credit) derives from this footprint
        plane_bits = occupancy.plane_bits if occupancy is not None else 8
        live_planes = (plane_bits - occupancy.dead_planes
                       if occupancy is not None else plane_bits)
        filter_bytes = compressed_filter_bytes(
            dense_resident, spec.M, plane_bits, live_planes)
    # §IV-E: a layer's batch-wide output set must stay staged until the next
    # layer consumes it; the reserved way holds inputs + outputs, so a layer
    # spills once its per-image output exceeds a quarter of the I/O way.
    cap = geom.io_way_bytes / 2
    spill = spec.output_bytes > cap / 2
    # §IV-E double buffering: one pass's filter columns must fit the output
    # half of the reserved way next to whatever outputs stay staged there
    # (spilled outputs live in DRAM and free the whole half for prefetch)
    executed = base_serial - skipped
    fb_per_pass = pass_filter_bytes(filter_bytes, executed)
    headroom = cap - (0 if spill else spec.output_bytes)
    ov = (overlap and spec.kind in ("conv", "fc") and executed > 1
          and filter_bytes > 0 and fb_per_pass <= headroom)
    return SlicePlan(
        spec=spec, mapped=mapped, batch=batch,
        K=K, row_bits=bs._row_layout(K)[0],
        tile_rows=tr, tile_filters=tf, batch_tile=batch_tile, tiles=tiles,
        filter_bytes=filter_bytes,
        input_bytes_per_image=spec.input_bytes,
        output_bytes_per_image=spec.output_bytes,
        serial_passes=base_serial,
        total_passes=base_serial * batch,
        spill_to_dram=spill,
        spill_bytes_per_image=2 * spec.output_bytes if spill else 0,
        quant_passes=quant_passes,
        minmax_cycles=minmax,
        occupancy=occupancy,
        skipped_passes=skipped,
        filter_bytes_per_pass=fb_per_pass,
        overlap=ov,
        integrity=bool(integrity) and spec.kind in ("conv", "fc"),
        quarantined_slices=quarantined,
        compressed=compressed,
        dense_filter_bytes=dense_resident,
        backend=backend,
    )


@dataclasses.dataclass(frozen=True)
class NetworkSchedule:
    """Per-layer :class:`SlicePlan` list for one network at one batch size.

    The ONE plan object every consumer shares: the packed engine executes
    it, the simulator prices it (``simulate_network(schedule)``), the
    serving engine admits batches against it, and the SLO latency model
    (core/slo.py) predicts per-batch latency from it.  Asserted
    invariants: ``filter_bytes_loaded`` is independent of ``batch``
    (§VI-C residency — filters load once per layer per batch), and
    ``simulate_network`` consuming a schedule reproduces the spec-planned
    numbers to 1e-12 (tests/test_schedule.py)."""

    layers: tuple[SlicePlan, ...]
    geom: CacheGeometry
    batch: int
    overlap: bool = False  # §IV-E double buffering requested for the net
    integrity: bool = False  # checksum verification requested
    compressed: bool = False  # CSR bit-plane filter residency
    backend: str | None = None  # execution backend pin (registry name)

    def plan(self, name: str) -> SlicePlan:
        for p in self.layers:
            if p.spec.name == name:
                return p
        raise KeyError(name)

    @property
    def filter_bytes_loaded(self) -> int:
        """Filter bytes loaded per batch — each layer's filters load ONCE
        and stay resident while the whole batch streams (§VI-C), so this
        is independent of ``batch``."""
        return sum(p.filter_bytes for p in self.layers)

    @property
    def spill_bytes_per_image(self) -> int:
        return sum(p.spill_bytes_per_image for p in self.layers)

    @property
    def total_passes(self) -> int:
        return sum(p.total_passes for p in self.layers)

    @property
    def skipped_passes(self) -> int:
        """Per-image serialized passes dropped by value sparsity, summed
        over layers (the network's skipped-pass credit)."""
        return sum(p.skipped_passes for p in self.layers)

    @property
    def overlapped_layers(self) -> int:
        """Layers whose per-pass filter loads stream under the previous
        pass's MAC+reduce (granted §IV-E double buffering)."""
        return sum(1 for p in self.layers if p.overlap)

    @property
    def residency_credit_bytes(self) -> int:
        """Filter bytes per batch that compression keeps off the load
        (dense live-set residency minus the compressed footprint, summed
        over layers); 0 for uncompressed schedules."""
        return sum(p.residency_credit_bytes for p in self.layers)

    @property
    def stream_batch_limit(self) -> int:
        """Images the reserved I/O way can stage at once for the widest
        layer (inputs + outputs share the way) — the §VI-C streaming
        bound; batches beyond it spill (see ``spill_to_dram``).  For
        uncompressed plans this is by construction independent of pruning:
        activations stream at full width whether or not filters are zero
        (asserted by tests/test_sparsity.py — a fully pruned network
        streams no deeper than a dense one).

        Compressed plans may additionally adopt the tighter
        per-layer staging accounting the compressed pipeline enables: a
        spilling layer's outputs round-trip DRAM (already priced per image
        via ``spill_bytes_per_image``) rather than staying staged, so they
        stop occupying the way, and the per-pass compressed filter chunk
        (``filter_bytes_per_pass``, the §IV-E streaming unit) is staged
        alongside the activations instead.  The runtime picks, PER LAYER,
        whichever discipline is narrower — legacy streaming is always
        still available — so compression never LOWERS the ceiling, and
        raises it where staged outputs (not filters) were the bottleneck
        (the full-network stem, today's limit-1 layers, goes 1 -> 2 at
        50% pruning; benchmarks/sched_breakdown.py gates this).
        Shrinking residency shrinks the packed width, so the limit is
        monotone non-decreasing in pruning (asserted by the
        tests/test_sparsity.py property sweep).  This is also the hard
        admission cap of the SLO serving policy (core/slo.py): admitted
        batches never exceed it."""
        def _width(p: SlicePlan) -> int:
            legacy = p.input_bytes_per_image + p.output_bytes_per_image
            if not self.compressed:
                return legacy
            packed = (p.input_bytes_per_image
                      + (0 if p.spill_to_dram else p.output_bytes_per_image)
                      + p.filter_bytes_per_pass)
            return min(legacy, packed)

        widest = max(_width(p) for p in self.layers)
        return max(1, self.geom.io_way_bytes // widest)


def plan_network(specs: Sequence[LayerSpec] | Iterable[LayerSpec],
                 geom: CacheGeometry = XEON_E5_35MB,
                 batch: int = 1,
                 occupancy: Mapping[str, LayerOccupancy] | None = None,
                 overlap: bool = False,
                 integrity: bool = False,
                 quarantined_slices: Sequence[int] = (),
                 compressed: bool = False,
                 backend: str | None = None,
                 ) -> NetworkSchedule:
    """Plan a network.  ``occupancy`` maps layer names to their
    :class:`LayerOccupancy` (layers absent from the map plan dense);
    ``overlap`` requests §IV-E double buffering for every layer (granted
    per layer by :func:`plan_layer`'s legality rule); ``integrity``
    requests checksum verification for every compute layer;
    ``quarantined_slices`` re-serializes every layer over the surviving
    slice pool, and ``compressed`` stores every compute layer's filters
    CSR-style per bit plane (residency, streaming and the
    batch ceiling all shrink/raise together).  ``backend`` pins every
    layer's execution backend to one registered name
    (core/backends.py) — a pure config change: consumers adopt
    ``schedule.backend`` with zero call-site edits."""
    occupancy = occupancy or {}
    if backend is not None:
        from repro_torch.core import backends as _backends
        backend = _backends.get_backend(backend,
                                        source="plan_network(backend=)").name
    return NetworkSchedule(
        tuple(plan_layer(s, geom, batch, occupancy=occupancy.get(s.name),
                         overlap=overlap, integrity=integrity,
                         quarantined_slices=quarantined_slices,
                         compressed=compressed, backend=backend)
              for s in specs), geom, batch, overlap, bool(integrity),
        bool(compressed), backend)


def prune_occupancy(specs: Iterable[LayerSpec], fraction: float = 0.5,
                    plane_bits: int = 8) -> dict[str, LayerOccupancy]:
    """Spec-driven fixed pruning: mark the LAST ``round(M * fraction)``
    filters of every conv/fc layer as zero.

    The deterministic counterpart of actually zeroing weights
    (models/inception.prune_wpack uses the same last-k rule, so a plan
    built here matches the engine's pack-time detection on the pruned
    weights).  Used by the golden cycle-model regression and the
    dense-vs-sparse benchmarks — no weight tensors needed: skipped-pass
    credits depend only on the zero-filter COUNT."""
    occ = {}
    for s in specs:
        if s.kind not in ("conv", "fc"):
            continue
        k = int(round(s.M * fraction))
        occ[s.name] = LayerOccupancy(
            total_filters=s.M, zero_filters=tuple(range(s.M - k, s.M)),
            plane_bits=plane_bits)
    return occ
