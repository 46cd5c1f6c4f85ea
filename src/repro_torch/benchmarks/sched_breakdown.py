"""Figure-13-style per-layer latency breakdown FROM THE SCHEDULE, plus the
throughput-vs-batch sweep (Figure 16 shape) validated against the paper's
headline, plus the dense-vs-sparse cycle breakdown of the sparsity-aware
scheduler (fixed 50% filter pruning of the full paper network), plus the
compressed-residency table, plus the SLO admission curve: predicted
latency-vs-batch from the cycle model (core/slo.py) next to the
throughput curve, and the batch the admission policy would pick per SLO
budget, plus the overlap-on/off per-block table (the double-buffered
pipeline's hidden-latency credit, gated both modeled — per-layer
overlapped <= serial — and measured).

All tables are priced off :class:`~repro_torch.core.schedule.NetworkSchedule`
objects — the same plan the packed-engine emulation and the serving engine
execute.  The module raises if a shape breaks (non-monotone throughput,
plateau off the paper's 604 inf/s by >10%, a sparse layer whose modeled
cycles do not drop by the skipped-pass credit exactly, a compressed plan
whose residency credit is off or whose ``stream_batch_limit`` is not
raised, a predicted latency curve that is not strictly increasing in the
batch, or an SLO-chosen batch past ``stream_batch_limit``), making it a
perf-model gate, not just a printer.  Every modeled row and gate is the
reference's (``benchmarks/sched_breakdown.py``).

Two inputs are measured on ``device`` (default ``cuda``) unless the
caller passes them, never read from a file of the reference's CPU
timings:

* the calibration wall (:func:`measure_calibration`): a batch-4
  ``nc_forward`` of ``reduced_config()`` with 50% of its filters pruned,
  run dense, from which the emulation-side SLO table calibrates its
  latency model;
* the overlap pair (:func:`measure_overlap`): serial and overlapped
  batch-4 walls of the reduced stem on the 1/4-scale array, timed in
  turns, held by :func:`overlap_gate`.
"""
from __future__ import annotations

import argparse
import math
import statistics
from collections import defaultdict

import torch

from repro_torch.benchmarks.common import (clock, overlap_wall_slack, row,
                                          same_bits)
from repro_torch.core.cache_geometry import XEON_E5_35MB
from repro_torch.core.schedule import plan_network, prune_occupancy
from repro_torch.core.simulator import (PAPER, batch_time_s,
                                        modeled_layer_cycles,
                                        simulate_network, throughput)
from repro_torch.core.slo import AdmissionPolicy, LatencyModel
from repro_torch.device import resolve_device
from repro_torch.models import inception
from repro_torch.models.inception import inception_v3_specs, reduced_config

BATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
PRUNE = 0.5  # the fixed dense-vs-sparse comparison point
SLO_BUDGETS_MS = (5, 10, 20, 50, 100)  # paper-scale (modeled hardware time)
SLO_BUDGETS_EMU_S = (1, 2, 4, 8)  # emulation wall-clock budgets
# the reference's name for the calibration wall (its record in the JAX
# package's timing harness), kept in the row's text
CALIBRATION_OP = "emulation/nc_forward_b4_pruned50_dense"
CALIBRATION_RUNS = 3  # min of this many dense runs, in turns with sparse
OVERLAP_RUNS = 5  # walls a side of the measured overlap pair, in turns


def _inputs(cfg, dev):
    """Seeded weights and a batch of 4 images for ``cfg`` on ``dev``."""
    params = inception.init_params(torch.Generator().manual_seed(0),
                                   config=cfg, device=dev)
    xb = torch.rand((4, cfg.img, cfg.img, 3),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    return params, xb


def calibration_case(device=None) -> dict:
    """The calibration's two forwards on ``device``: ``reduced_config()``
    at batch 4 with the last 50% of every conv's filters zeroed
    (``prune_wpack``), run ``"dense"`` and on the ``"sparse"`` schedule.
    Each entry is a zero-argument call returning ``nc_forward``'s
    ``(logits, report)``."""
    dev = resolve_device(device)
    cfg = reduced_config()
    params, xb = _inputs(cfg, dev)
    wpack = inception.prune_wpack(
        inception.prepare_conv_weights(params, cfg), PRUNE)

    def forward(**kw):
        return inception.nc_forward(params, xb, config=cfg, wpack=wpack,
                                    device=dev, **kw)

    return {"dense": forward, "sparse": lambda: forward(sparse=True)}


def overlap_case(device=None) -> dict:
    """The overlap pair's two forwards on ``device``:
    ``reduced_config(width_div=2, stages=())`` at batch 4 on
    ``XEON_E5_35MB.scaled(4)`` (at the full array every reduced layer is
    single-pass and the §IV-E rule grants no overlap), ``"serial"`` and
    ``"overlapped"``, each a zero-argument call as in
    :func:`calibration_case`."""
    dev = resolve_device(device)
    cfg = reduced_config(width_div=2, stages=())
    params, xb = _inputs(cfg, dev)
    wpack = inception.prepare_conv_weights(params, cfg)

    def forward(overlap):
        return inception.nc_forward(params, xb, config=cfg,
                                    geom=XEON_E5_35MB.scaled(4), wpack=wpack,
                                    overlap=overlap, device=dev)

    return {"serial": lambda: forward(False),
            "overlapped": lambda: forward(True)}


def calibration_walls(device=None, *, logits=None) -> dict:
    """The walls in seconds of :func:`calibration_case`'s forwards,
    ``CALIBRATION_RUNS`` each, dense and sparse in turns (as the
    reference's harness times the pair); each wall waits for the card.
    Raises unless the two sides' logits are byte-identical; ``logits``,
    when given, receives each side's last logits."""
    forwards = calibration_case(device)
    walls = {name: [] for name in forwards}
    out = {}
    for _ in range(CALIBRATION_RUNS):
        for name, forward in forwards.items():
            t0 = clock()
            out[name], _ = forward()
            walls[name].append(clock() - t0)
        if not same_bits(out["dense"], out["sparse"]):
            raise RuntimeError("calibration: sparse nc_forward logits "
                               "diverge from dense on the same pruned "
                               "weights")
    if logits is not None:
        logits.update(out)
    return walls


def measure_calibration(device=None) -> float:
    """The calibration wall in seconds: the least of
    :func:`calibration_walls`' dense walls."""
    return min(calibration_walls(device)["dense"])


def measure_overlap(device=None, *, logits=None
                    ) -> tuple[list[float], list[float]]:
    """Serial and overlapped walls in seconds of :func:`overlap_case`'s
    forwards, ``OVERLAP_RUNS`` a side, timed in turns after one warm call
    of each (the side that goes first alternates).  Raises unless the two
    sides' logits are byte-identical and at least one layer ran with
    ``overlap`` set; ``logits``, when given, receives each side's logits
    from the warm call."""
    forwards = overlap_case(device)
    serial_logits, _ = forwards["serial"]()
    overlapped_logits, report = forwards["overlapped"]()
    if not same_bits(serial_logits, overlapped_logits):
        raise RuntimeError("overlap gate: overlapped nc_forward logits "
                           "diverge from serial on the same weights")
    if not any(l.overlap for l in report.layers):
        raise RuntimeError("overlap gate: no layer executed double-buffered "
                           "— the pair would be measuring noise")
    if logits is not None:
        logits.update(serial=serial_logits, overlapped=overlapped_logits)
    walls = {"serial": [], "overlapped": []}
    for i in range(OVERLAP_RUNS):
        for name in (("serial", "overlapped") if i % 2 == 0
                     else ("overlapped", "serial")):
            t0 = clock()
            forwards[name]()
            walls[name].append(clock() - t0)
    return walls["serial"], walls["overlapped"]


def overlap_gate(serial, overlapped) -> tuple[float, float, float]:
    """Hold the measured overlap pair: the overlapped median at most
    ``overlap_wall_slack()`` x the serial median plus the larger of the two
    sides' spreads (max - min).  The port runs overlap plans serially, so
    the pair times one computation twice and the spread is its noise;
    given one wall a side the rule is the reference's.  Returns the two
    medians and the spread; raises when the double buffer became a
    cost."""
    ws, wo = statistics.median(serial), statistics.median(overlapped)
    spread = max(max(serial) - min(serial),
                 max(overlapped) - min(overlapped))
    slack = overlap_wall_slack()
    if wo > slack * ws + spread:
        raise RuntimeError(
            f"measured overlapped wall {wo:.2f} s exceeds {slack:.2f}x "
            f"serial {ws:.2f} s plus the spread {spread:.2f} s (batch-4 "
            f"reduced stem, {len(serial)} and {len(overlapped)} runs in "
            f"turns) — the double buffer became a cost")
    return ws, wo, spread


def run(*, device=None, calibration_wall_s: float | None = None,
        overlap_walls=None) -> list[str]:
    """Every table with its gates.  ``calibration_wall_s`` (seconds) and
    ``overlap_walls`` (serial walls, overlapped walls) are measured on
    ``device`` (default ``cuda``) when not given."""
    if calibration_wall_s is None:
        calibration_wall_s = measure_calibration(device)
    if overlap_walls is None:
        overlap_walls = measure_overlap(device)

    specs = inception_v3_specs()
    schedule = plan_network(specs, XEON_E5_35MB, batch=64)
    r = simulate_network(schedule)
    rows = []

    # per-block latency with the Figure-14 component split, per layer plan
    per_block = defaultdict(lambda: defaultdict(float))
    for l in r.layers:
        b = per_block[l.spec.block]
        b["filter"] += l.filter_s
        b["input"] += l.input_s
        b["output"] += l.output_s
        b["mac"] += l.mac_s
        b["reduce"] += l.reduce_s
        b["quant"] += l.quant_s
        b["pool"] += l.pool_s
    for block, parts in per_block.items():
        total = sum(parts.values())
        split = " ".join(f"{k}={v / total:.0%}" for k, v in parts.items()
                         if v / total >= 0.005)
        rows.append(row(f"sched13/{block}", total * 1e6, split))
    rows.append(row("sched13/TOTAL", r.latency_s * 1e6,
                    f"filters loaded once/batch: "
                    f"{r.filter_bytes_loaded / 1e6:.1f} MB"))

    # throughput-vs-batch sweep off the same schedule's spill decisions
    tps = [throughput(r, b) for b in BATCHES]
    for b, tp in zip(BATCHES, tps):
        rows.append(row(f"sched13/throughput_batch_{b}", 1e6 / tp,
                        f"{tp:.1f} inf/s (dual socket)"))
    # shape validation: monotone ramp to a plateau at the paper's headline
    if not all(b >= a for a, b in zip(tps, tps[1:])):
        raise RuntimeError(f"throughput-vs-batch not monotone: {tps}")
    plateau = tps[BATCHES.index(64)]
    err = abs(plateau - PAPER["nc_throughput"]) / PAPER["nc_throughput"]
    if err > 0.10:
        raise RuntimeError(
            f"batch-64 plateau {plateau:.1f} inf/s deviates {err:.1%} from "
            f"the paper's {PAPER['nc_throughput']}")
    if tps[-1] - plateau > 0.05 * plateau:
        raise RuntimeError("no plateau: batch 256 still gaining >5%")
    rows.append(row("sched13/throughput_shape", 0.0,
                    f"monotone, plateau {plateau:.1f} inf/s "
                    f"({err:.1%} vs paper), spill "
                    f"{schedule.spill_bytes_per_image / 1e6:.2f} MB/img"))

    # dense-vs-sparse modeled cycles per layer: the sparsity-aware scheduler
    # on the FULL paper network with a fixed 50% filter pruning (per-block
    # rows; exactness asserted per layer)
    occ = prune_occupancy(specs, PRUNE)
    sparse = plan_network(specs, XEON_E5_35MB, batch=64, occupancy=occ)
    per_block = defaultdict(lambda: [0.0, 0.0, 0])
    for pd, ps in zip(schedule.layers, sparse.layers):
        md = modeled_layer_cycles(pd)
        ms = modeled_layer_cycles(ps)
        if md["total_cycles"] - ms["total_cycles"] != ms["skip_credit_cycles"]:
            raise RuntimeError(
                f"{pd.spec.name}: sparse modeled cycles off the skipped-pass "
                f"credit ({md['total_cycles']} - {ms['total_cycles']} != "
                f"{ms['skip_credit_cycles']})")
        b = per_block[pd.spec.block]
        b[0] += md["total_cycles"]
        b[1] += ms["total_cycles"]
        b[2] += ms["skipped_passes"]
    for block, (cd, cs, skipped) in per_block.items():
        rows.append(row(f"sparsity/{block}", cd - cs,
                        f"dense {cd:.0f} -> sparse {cs:.0f} cycles "
                        f"({skipped} passes skipped at {PRUNE:.0%} pruning)"))
    total_d = sum(v[0] for v in per_block.values())
    total_s = sum(v[1] for v in per_block.values())
    rows.append(row("sparsity/TOTAL", total_d - total_s,
                    f"modeled cycles {total_d:.0f} -> {total_s:.0f} "
                    f"({1 - total_s / total_d:.1%} credited), filter bytes "
                    f"{schedule.filter_bytes_loaded / 1e6:.1f} -> "
                    f"{sparse.filter_bytes_loaded / 1e6:.1f} MB, "
                    f"{sparse.skipped_passes} passes/img skipped"))
    rows.extend(_compression_rows(specs))
    rows.extend(_overlap_rows(specs, r, overlap_walls))
    rows.extend(_slo_rows(specs, calibration_wall_s))
    return rows


def _compression_rows(specs) -> list[str]:
    """Compressed-residency table on the FULL paper network,
    fixed 50% pruning at batch 64.  Gates:

    * per-layer exactness — sparse minus compressed modeled time must
      equal the residency credit to 1e-12 for every layer (the simulator
      prices compression as an exact additive credit, nothing else moves);
    * the network ``stream_batch_limit`` must be STRICTLY higher under
      compression (today's full-network limit is 1 — the stem's staged
      activations fill the reserved way; the compressed staging rule
      spills those outputs per image and stages the per-pass filter chunk
      instead), and every stem layer that was a limit-1 bottleneck must
      individually stage deeper;
    * the SLO-chosen batch at the widest budget must actually follow the
      raised ceiling — higher than the dense-planned choice and never
      past the compressed limit."""
    occ = prune_occupancy(specs, PRUNE)
    dense = plan_network(specs, XEON_E5_35MB, batch=64)
    sparse = plan_network(specs, XEON_E5_35MB, batch=64, occupancy=occ)
    comp = plan_network(specs, XEON_E5_35MB, batch=64, occupancy=occ,
                        compressed=True)
    rows = []
    rs, rc = simulate_network(sparse), simulate_network(comp)
    for ls, lc in zip(rs.layers, rc.layers):
        if abs((ls.total_s - lc.total_s) - lc.residency_credit_s) > 1e-12:
            raise RuntimeError(
                f"{ls.spec.name}: compressed modeled time off the "
                f"residency credit ({ls.total_s} - {lc.total_s} != "
                f"{lc.residency_credit_s})")
    ratio = comp.filter_bytes_loaded / dense.filter_bytes_loaded
    rows.append(row(
        "compression/residency", comp.residency_credit_bytes,
        f"filter bytes {dense.filter_bytes_loaded / 1e6:.1f} -> "
        f"{comp.filter_bytes_loaded / 1e6:.1f} MB resident "
        f"({ratio:.3f}x dense at {PRUNE:.0%} pruning); credit vs the "
        f"sparse dense-store plan {rc.residency_credit_s * 1e6:.1f} "
        f"us/batch (negative = CSR index overhead with all 8 bit-planes "
        f"live)"))

    d_limit, c_limit = dense.stream_batch_limit, comp.stream_batch_limit
    if c_limit <= d_limit:
        raise RuntimeError(
            f"compression gate: stream_batch_limit {c_limit} not raised "
            f"over the dense plan's {d_limit} on the full paper network — "
            f"the compressed staging rule stopped lifting the §VI-C "
            f"ceiling")
    io_way = XEON_E5_35MB.io_way_bytes
    for pd, pc in zip(dense.layers, comp.layers):
        if pd.spec.block or pd.spec.kind not in ("conv", "fc"):
            continue  # stem only: today's limit-1 bottleneck layers
        legacy = pd.input_bytes_per_image + pd.output_bytes_per_image
        if max(1, io_way // legacy) > 1:
            continue
        packed = (pc.input_bytes_per_image
                  + (0 if pc.spill_to_dram else pc.output_bytes_per_image)
                  + pc.filter_bytes_per_pass)
        if max(1, io_way // min(legacy, packed)) <= 1:
            raise RuntimeError(
                f"compression gate: stem bottleneck {pd.spec.name} still "
                f"stages only 1 image under compression")
    rows.append(row("compression/stream_limit", c_limit,
                    f"stream_batch_limit {d_limit} -> {c_limit} "
                    f"(stem spills outputs per image, stages compressed "
                    f"filter chunks instead)"))

    # the raised ceiling must reach the SLO admission policy
    model_d = LatencyModel(
        lambda b: plan_network(specs, XEON_E5_35MB, batch=b))
    model_c = LatencyModel(
        lambda b: plan_network(specs, XEON_E5_35MB, batch=b,
                               occupancy=occ, compressed=True))
    budget_s = max(SLO_BUDGETS_MS) / 1e3
    n_d = AdmissionPolicy(model_d, budget_s,
                          max_batch=max(BATCHES)).target_batch(budget_s)
    n_c = AdmissionPolicy(model_c, budget_s,
                          max_batch=max(BATCHES)).target_batch(budget_s)
    if n_c > model_c.stream_batch_limit:
        raise RuntimeError(
            f"compression gate: SLO-chosen batch {n_c} exceeds the "
            f"compressed stream_batch_limit {model_c.stream_batch_limit}")
    if n_c <= n_d:
        raise RuntimeError(
            f"compression gate: SLO-chosen batch under compression "
            f"({n_c}) does not exceed the dense choice ({n_d}) at "
            f"{max(SLO_BUDGETS_MS)} ms — the raised ceiling never "
            f"reached the admission policy")
    rows.append(row(
        "compression/slo_batch", n_c,
        f"SLO-chosen batch {n_d} -> {n_c} at {max(SLO_BUDGETS_MS)} ms "
        f"(p99 {model_c.predict_p99_s(n_c) * 1e3:.2f} ms, compressed "
        f"stream limit {model_c.stream_batch_limit})"))
    return rows


def _overlap_rows(specs, rs, overlap_walls) -> list[str]:
    """Overlap-on/off per-block table: the hidden-latency credit of the
    double-buffered plan on the FULL paper network at batch 64.

    Gates:

    * every layer's overlapped modeled time (``total_s - hidden_s``) must
      be <= its serial time — overlap re-prices the filter load, never the
      compute, so a layer that got slower means the credit went negative;
    * the total hidden credit must be nonzero (the §IV-E headroom rule
      grants overlap on most paper layers; zero means the legality
      decision broke);
    * the batch-64 identity ``batch_time_s(overlap) == batch_time_s(serial)
      - hidden_s`` must hold — the credit the serving ``LatencyModel``
      calibrates against is exactly the per-layer sum;
    * the MEASURED pair (``overlap_walls``: batch-4 reduced stem,
      measured by :func:`measure_overlap` with logits asserted identical)
      must pass :func:`overlap_gate` — the model's floor for the measured
      win is zero (overlap re-times the copies, never the computed
      values), so a pair where the double buffer became a cost fails the
      run.  The row keeps the reference's text."""
    ov = plan_network(specs, XEON_E5_35MB, batch=64, overlap=True)
    ro = simulate_network(ov)
    rows = []
    per_block = defaultdict(lambda: [0.0, 0.0, 0])
    for ls, lo in zip(rs.layers, ro.layers):
        serial_t = ls.total_s
        ov_t = lo.total_s - lo.hidden_s
        if ov_t > serial_t + 1e-15:
            raise RuntimeError(
                f"{ls.spec.name}: overlapped modeled time {ov_t:.3e} s "
                f"exceeds serial {serial_t:.3e} s — negative hidden credit")
        b = per_block[ls.spec.block]
        b[0] += serial_t
        b[1] += ov_t
        b[2] += 1 if lo.overlap else 0
    for block, (ts, to, n) in per_block.items():
        rows.append(row(f"overlap/{block}", (ts - to) * 1e6,
                        f"serial {ts * 1e3:.3f} -> overlapped "
                        f"{to * 1e3:.3f} ms/img ({n} layers "
                        f"double-buffered)"))
    hidden = ro.hidden_s
    if hidden <= 0.0:
        raise RuntimeError(
            "overlap hides no filter-load time on the paper network — the "
            "§IV-E headroom rule should grant most conv layers")
    bt_s, bt_o = batch_time_s(rs, 64), batch_time_s(ro, 64)
    if not math.isclose(bt_o, bt_s - hidden, rel_tol=1e-9):
        raise RuntimeError(
            f"batch-64 overlap identity broken: {bt_o} != {bt_s} - {hidden}")
    rows.append(row(
        "overlap/TOTAL", hidden * 1e6,
        f"hidden {hidden * 1e3:.3f} of {ro.filter_s * 1e3:.3f} ms filter "
        f"time ({ov.overlapped_layers}/{len(ov.layers)} layers); "
        f"latency {rs.latency_s * 1e3:.2f} -> "
        f"{ro.overlapped_latency_s * 1e3:.2f} ms/img, batch-64 "
        f"{bt_s * 1e3:.2f} -> {bt_o * 1e3:.2f} ms"))

    # measured gate: the batch-4 reduced-stem pair, in turns
    ws, wo, _ = overlap_gate(*overlap_walls)
    slack = overlap_wall_slack()
    rows.append(row("overlap/measured_b4", (ws - wo) * 1e6,
                    f"serial {ws:.2f} -> overlapped {wo:.2f} s wall "
                    f"({ws / wo:.2f}x, batch-4 reduced stem on the "
                    f"1/4-scale array, logits byte-identical per "
                    f"kernel_bench gate, slack {slack:.2f}x)"))
    return rows


def _slo_rows(specs, wall4_s: float) -> list[str]:
    """Latency-vs-batch curve + SLO-chosen batch, both gated.

    Paper scale: the uncalibrated model predicts modeled hardware time;
    the curve must be strictly increasing in the batch (the admission
    policy bisects it) and the chosen batch can never pass the §VI-C
    ``stream_batch_limit`` (1 at paper scale — the stem's activations
    fill the reserved way, so SLO admission there runs single images and
    the spill cost inside the curve is what batching would pay).

    Emulation scale: a reduced-config model calibrated from the measured
    batch-4 wall time ``wall4_s`` (seconds) shows the policy actually
    walking batch sizes as the budget grows."""
    rows = []
    model = LatencyModel(lambda b: plan_network(specs, XEON_E5_35MB, batch=b))
    lat = [model.predict_p99_s(b) for b in BATCHES]
    for b, l, p in zip(BATCHES, lat, (model.predict_s(b) for b in BATCHES)):
        rows.append(row(f"slo/latency_batch_{b}", l * 1e6,
                        f"predicted {p * 1e3:.2f} ms, p99 {l * 1e3:.2f} ms "
                        f"(modeled hardware time)"))
    if not all(b > a for a, b in zip(lat, lat[1:])):
        raise RuntimeError(
            f"predicted latency not strictly increasing in batch: {lat}")
    limit = model.stream_batch_limit
    chosen = []
    # NOTE: the policy's batch_cap already clamps to the stream limit, so
    # these raises are TRIPWIRES for cap-logic regressions, not live
    # checks: at paper scale (limit 1, budgets up to 100 ms) any future
    # change that drops the stream clamp from AdmissionPolicy.batch_cap
    # immediately picks a multi-image batch here and fails the gate.
    for ms in SLO_BUDGETS_MS:
        pol = AdmissionPolicy(model, ms / 1e3, max_batch=max(BATCHES))
        n = pol.target_batch(ms / 1e3)
        chosen.append(n)
        if n > limit:
            raise RuntimeError(
                f"SLO-chosen batch {n} exceeds stream_batch_limit {limit} "
                f"at {ms} ms")
        cmp = "<=" if model.predict_p99_s(n) <= ms / 1e3 else "> (floor: miss)"
        rows.append(row(f"slo/batch_for_slo_{ms}ms", n,
                        f"p99 {model.predict_p99_s(n) * 1e3:.2f} ms {cmp} "
                        f"{ms} ms budget (stream limit {limit})"))
    if chosen != sorted(chosen):
        raise RuntimeError(f"SLO-chosen batch not monotone in budget: "
                           f"{chosen}")

    # emulation-side: calibrate from the measured batch-4 wall time
    cfg = reduced_config()
    rspecs = inception_v3_specs(cfg)
    emu = LatencyModel(lambda b: plan_network(rspecs, XEON_E5_35MB, batch=b))
    emu.observe(4, wall4_s)
    rlimit = emu.stream_batch_limit
    rows.append(row("slo/calibration", emu.scale,
                    f"reduced-config wall/modeled x{emu.scale:.0f} from "
                    f"{CALIBRATION_OP} ({wall4_s:.2f} s at batch 4)"))
    prev = 0
    for s in SLO_BUDGETS_EMU_S:
        pol = AdmissionPolicy(emu, float(s), max_batch=64)
        n = pol.target_batch(float(s))
        if n > rlimit:
            raise RuntimeError(
                f"SLO-chosen batch {n} exceeds stream_batch_limit "
                f"{rlimit} at {s} s (emulation)")
        if n < prev:
            raise RuntimeError(
                f"emulation SLO-chosen batch not monotone in budget at "
                f"{s} s: {n} < {prev}")
        prev = n
        rows.append(row(f"slo/batch_for_slo_{s}s_emulated", n,
                        f"calibrated p99 {emu.predict_p99_s(n):.2f} s <= "
                        f"{s} s budget (stream limit {rlimit}, cap 64)"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the two inputs are measured: cuda "
                         "(default) needs a GPU; cpu runs without one")
    args = ap.parse_args(argv)
    print("\n".join(run(device=resolve_device(args.device))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
