"""Neural Cache image serving (§VI-C batched streaming) on the GPU.

The port of ``repro.launch.serve``'s image path: :class:`NCServingEngine`
admits queued image requests into batches and runs each batch as ONE
``models.inception.nc_forward`` through the bit-serial emulation, with the
filters resident and the per-layer plan taken from a
:class:`~repro_torch.core.schedule.NetworkSchedule` planned once per batch
size.  With ``slo_ms`` the admission policy of ``core/slo.py`` sizes the
batches from the cycle model calibrated against measured batch walls.  The
LM serving engine is not part of this package yet.

Usage:
    python -m repro_torch.launch.serve --neural-cache --requests 8
    python -m repro_torch.launch.serve --neural-cache --full --requests 4 --max-batch 2
    python -m repro_torch.launch.serve --neural-cache --device cpu --requests 2
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.core import backends as nc_backends
from repro_torch.core import schedule as nc_schedule
from repro_torch.core import slo as nc_slo
from repro_torch.core.cache_geometry import XEON_E5_35MB
from repro_torch.device import resolve_device
from repro_torch.kernels.bitserial_matmul import KernelError
from repro_torch.launch.engine_api import Engine as _EngineAPI
from repro_torch.models import inception


class BatchQueueEngine:
    """Shared admission plumbing: a request queue drained by ``step()``.

    An exception raised while executing one admitted batch fails ONLY that
    batch: its requests land in ``failed`` with the error recorded and the
    engine keeps draining the queue."""

    def __init__(self):
        self.queue = []
        self.completed = []
        self.failed = []
        self.errors: list[str] = []
        self.steps = 0

    def submit(self, req) -> None:
        self.queue.append(req)

    def _fail_requests(self, reqs, err: BaseException | str) -> None:
        msg = ((str(err) or type(err).__name__)
               if isinstance(err, BaseException) else str(err))
        self.errors.append(msg)
        for r in reqs:
            r.done = True
            r.failed = True
            r.error = msg
            self.failed.append(r)


@dataclasses.dataclass
class NCRequest:
    rid: int
    image: object  # [H, W, 3] float32 in [0, 1] (numpy array or tensor)
    logits: torch.Tensor | None = None
    done: bool = False
    failed: bool = False  # unrecoverable after the degradation ladder
    error: str | None = None
    degraded: str | None = None  # "fallback-schedule" | "float" when not primary
    arrival_t: float = 0.0  # engine-clock submit time
    latency_s: float | None = None  # queue wait + batch execution wall
    slo_ok: bool | None = None  # None when the engine has no SLO set


class NCServingEngine(BatchQueueEngine, _EngineAPI):
    """Batched Neural Cache inference server on ``device`` (default
    ``"cuda"``; raises without a GPU unless ``device="cpu"``).

    The behaviour is the reference's: ``sparse`` plans against the deployed
    weights' detected zero filters, ``overlap`` plans §IV-E double
    buffering, ``warmup_replan`` re-plans from the first batch's measured
    occupancy, ``slo_ms`` arms the SLO-aware admission policy, and a batch
    whose forward raises walks the recovery ladder (``_recover``); a
    :class:`~repro_torch.kernels.bitserial_matmul.KernelError` (a kernel that
    did not build or launch) is re-raised instead, never served degraded.
    ``integrity`` and ``compressed`` are not part of this package yet and
    raise.  The clock is injectable (``now_fn``, or ``now=`` on
    ``submit``/``step``).  Each request's ``logits`` is a tensor on the
    device."""

    def __init__(self, params, config=None, *, max_batch: int = 4,
                 geom=None, engine: str | None = None, sparse: bool = True,
                 overlap: bool = True, integrity: bool = False,
                 compressed: bool = False, warmup_replan: bool = False,
                 slo_ms: float | None = None,
                 hold_slack_ms: float | None = None, now_fn=time.monotonic,
                 name: str = "nc-engine",
                 device: str | torch.device | None = None):
        if integrity:
            raise NotImplementedError(
                "integrity serving comes with the port's faults/integrity slice")
        if compressed:
            raise NotImplementedError(
                "compressed residency comes with the port's CompressedPlanes "
                "slice")
        super().__init__()
        self.device = resolve_device(device)
        self.name = name
        self.config = config or inception.REDUCED
        self.params = params
        self.max_batch = max_batch
        self.geom = geom or XEON_E5_35MB
        if engine is not None:
            engine = nc_backends.get_backend(engine).name
        self.engine = engine
        self.now_fn = now_fn
        self.specs = inception.inception_v3_specs(self.config)
        # resident filters quantize ONCE per deployment
        self.wpack = inception.prepare_conv_weights(params, self.config)
        self.occupancy = (inception.network_occupancy(self.wpack, self.config)
                          if sparse else None)
        self.overlap = overlap
        self.integrity = False
        self.compressed = False
        self.warmup_replan = warmup_replan
        self._warmup_pending = bool(warmup_replan)
        self.warmup_replans = 0
        self.schedule = self._plan(max_batch, self.occupancy, self.overlap)
        self._schedules = {max_batch: self.schedule}
        self._fallback_schedules: dict = {}
        self.retries = 0
        self.degraded_batches = 0
        self.reports = []
        self.latency_model = nc_slo.LatencyModel(self._schedule_for)
        self.arrivals = nc_slo.ArrivalRateEstimator()
        self.slo_s = slo_ms / 1e3 if slo_ms is not None else None
        self.policy = None
        if self.slo_s is not None:
            self.policy = nc_slo.AdmissionPolicy(
                self.latency_model, self.slo_s, max_batch,
                hold_slack_s=(hold_slack_ms / 1e3
                              if hold_slack_ms is not None else None),
                arrivals=self.arrivals)
        self.decisions = []
        self.batch_histogram: dict[int, int] = {}
        self.slo_hits = 0
        self.slo_misses = 0

    def _plan(self, n: int, occupancy, overlap: bool):
        return nc_schedule.plan_network(self.specs, self.geom, batch=n,
                                        occupancy=occupancy, overlap=overlap)

    def _schedule_for(self, n: int):
        if n not in self._schedules:
            self._schedules[n] = self._plan(n, self.occupancy, self.overlap)
        return self._schedules[n]

    def _fallback_schedule_for(self, n: int):
        """Degradation rung 2's plan: dense and serial."""
        if n not in self._fallback_schedules:
            self._fallback_schedules[n] = self._plan(n, None, False)
        return self._fallback_schedules[n]

    def _replan_from_report(self, report) -> None:
        """Warmup re-planning: re-plan every batch size from the occupancy
        the warmup batch measured and drop the latency model's priced plans."""
        self.occupancy = inception.observed_occupancy(
            self.wpack, self.config, report)
        self._schedules.clear()
        self.schedule = self._schedule_for(self.max_batch)
        self.latency_model.invalidate_plans()
        self.warmup_replans += 1

    def set_engine(self, engine: str | None) -> None:
        """Switch the execution backend and reset the latency model's plans
        and calibration (wall time per modeled cycle belongs to a backend)."""
        if engine is not None:
            engine = nc_backends.get_backend(engine).name
        if engine == self.engine:
            return
        self.engine = engine
        self.latency_model.invalidate_plans()
        self.latency_model.reset_calibration()

    def _forward(self, x: torch.Tensor, schedule):
        """One batched forward through the planned emulation."""
        return inception.nc_forward(
            self.params, x, config=self.config, geom=self.geom,
            engine=self.engine, schedule=schedule, wpack=self.wpack,
            device=self.device)

    def submit(self, req, now: float | None = None) -> None:
        req.arrival_t = self.now_fn() if now is None else now
        self.arrivals.observe(req.arrival_t)
        super().submit(req)

    def step(self, now: float | None = None, *, flush: bool = False) -> bool:
        """Admit a batch (policy-sized under an SLO, greedy FIFO otherwise)
        and execute it.  False when nothing was admitted."""
        if not self.queue:
            return False
        now = self.now_fn() if now is None else now
        if self.policy is None:
            n = min(self.max_batch, len(self.queue))
        else:
            decision = self.policy.admit(
                len(self.queue), now - self.queue[0].arrival_t, flush=flush)
            self.decisions.append(decision)
            if decision.admit == 0:
                return False
            n = decision.admit
        batch = [self.queue.pop(0) for _ in range(n)]
        x = torch.stack([torch.as_tensor(r.image, dtype=torch.float32)
                         .to(self.device) for r in batch])
        t0 = time.perf_counter()
        try:
            logits, report = self._forward(x, self._schedule_for(len(batch)))
            degraded = None
        except KernelError:
            raise
        except Exception as e:  # noqa: BLE001 — recovery ladder below
            logits, report, degraded = self._recover(batch, x, now, e)
            if logits is None:
                # the whole ladder failed: the batch still happened — it
                # lands in the histogram, its requests count as SLO misses
                # and its wall is excluded from calibration
                wall = time.perf_counter() - t0
                self.latency_model.exclude(n, wall)
                self.batch_histogram[n] = self.batch_histogram.get(n, 0) + 1
                for r in batch:
                    r.latency_s = (now - r.arrival_t) + wall
                    if self.slo_s is not None:
                        r.slo_ok = False
                        self.slo_misses += 1
                self.steps += 1
                return True
        wall = time.perf_counter() - t0
        if degraded is None:
            if self._warmup_pending and report is not None:
                self._warmup_pending = False
                self._replan_from_report(report)
                self.latency_model.exclude(len(batch), wall)
            else:
                self.latency_model.observe(len(batch), wall)
        else:
            self.latency_model.exclude(len(batch), wall)
            self.degraded_batches += 1
        self.batch_histogram[n] = self.batch_histogram.get(n, 0) + 1
        for i, r in enumerate(batch):
            r.logits = logits[i]
            r.done = True
            r.degraded = degraded
            r.latency_s = (now - r.arrival_t) + wall
            if self.slo_s is not None:
                r.slo_ok = r.latency_s <= self.slo_s
                if r.slo_ok:
                    self.slo_hits += 1
                else:
                    self.slo_misses += 1
            self.completed.append(r)
        if report is not None:
            self.reports.append(report)
        self.steps += 1
        return True

    def _recover(self, batch, x, now: float, err: BaseException):
        """Degradation ladder for a failed batch: (1) primary-schedule
        retries within the oldest request's deadline budget (one without an
        SLO), (2) the dense/serial fallback schedule, (3) the float forward,
        (4) mark the batch failed.  Returns ``(logits, report, tag)``;
        logits None means rung 4."""
        n = len(batch)
        last = err
        retries_left = 1
        if self.slo_s is not None:
            budget = self.slo_s - (now - batch[0].arrival_t)
            predicted = max(self.latency_model.predict_s(n), 1e-9)
            retries_left = max(0, int(budget / predicted) - 1)
        while retries_left > 0:
            retries_left -= 1
            self.retries += 1
            try:
                logits, report = self._forward(x, self._schedule_for(n))
                return logits, report, None
            except KernelError:
                raise
            except Exception as e:  # noqa: BLE001
                last = e
        try:
            logits, report = self._forward(x, self._fallback_schedule_for(n))
            return logits, report, "fallback-schedule"
        except KernelError:
            raise
        except Exception as e:  # noqa: BLE001
            last = e
        try:
            logits = inception.apply(self.params, x, config=self.config)
            return logits, None, "float"
        except Exception as e:  # noqa: BLE001
            last = e
        self._fail_requests(batch, last)
        return None, None, None

    @property
    def slo_hit_rate(self) -> float | None:
        total = self.slo_hits + self.slo_misses
        return self.slo_hits / total if total else None

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def batch_cap(self) -> int:
        """``max_batch`` and the §VI-C streaming limit, whichever bites."""
        if self.policy is not None:
            return self.policy.batch_cap
        return max(1, min(self.max_batch,
                          self.latency_model.stream_batch_limit))

    def stats(self) -> dict:
        """Admitted-batch histogram, SLO accounting, calibration state and
        the recovery ledger (keys as the reference's)."""
        return dict(
            steps=self.steps,
            completed=len(self.completed),
            batch_histogram=dict(sorted(self.batch_histogram.items())),
            slo_ms=self.slo_s * 1e3 if self.slo_s is not None else None,
            slo_hits=self.slo_hits,
            slo_misses=self.slo_misses,
            slo_hit_rate=self.slo_hit_rate,
            calibration_scale=self.latency_model.scale,
            calibration_samples=self.latency_model.samples,
            calibration_excluded=self.latency_model.excluded,
            stream_batch_limit=self.schedule.stream_batch_limit,
            integrity=self.integrity,
            compressed=self.compressed,
            residency_credit_bytes=self.schedule.residency_credit_bytes,
            warmup_replans=self.warmup_replans,
            failed=len(self.failed),
            errors=list(self.errors),
            retries=self.retries,
            degraded_batches=self.degraded_batches,
        )

    def run(self) -> list[NCRequest]:
        # draining: no more arrivals are coming, so flush
        while self.queue:
            self.step(flush=True)
        return self.completed


def _main_neural_cache(args) -> int:
    from repro_torch.core.simulator import simulate_network, throughput

    device = resolve_device(args.device)
    cfg = inception.FULL if args.full else inception.reduced_config()
    params = inception.init_params(torch.Generator().manual_seed(args.seed),
                                   config=cfg, device=device)
    engine = NCServingEngine(params, cfg, max_batch=args.max_batch,
                             overlap=not args.no_overlap,
                             warmup_replan=args.warmup_replan,
                             slo_ms=args.slo_ms, device=device)
    rng = np.random.default_rng(args.seed)
    for r in range(args.requests):
        engine.submit(NCRequest(
            rid=r, image=rng.random((cfg.img, cfg.img, 3), dtype=np.float32)))
    t0 = time.perf_counter()
    done = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    res = simulate_network(engine.schedule)
    tp = throughput(res, args.max_batch, sockets=1)
    finite = all(bool(torch.isfinite(r.logits).all()) for r in done)
    print(f"[serve-nc] {cfg.name} on {device}: {len(done)} images in "
          f"{dt:.2f}s emulated ({engine.steps} batches of <= "
          f"{args.max_batch}, logits finite: {finite}); modeled: "
          f"{res.latency_s * 1e3:.3f} ms/img unbatched, {tp:.0f} inf/s at "
          f"batch {args.max_batch} (single socket)")
    if args.slo_ms is not None:
        s = engine.stats()
        print(f"[serve-nc] SLO {args.slo_ms:.0f} ms: hit rate "
              f"{s['slo_hit_rate']:.0%}, admitted batches "
              f"{s['batch_histogram']}")
    return 0 if finite and len(done) == args.requests else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--neural-cache", action="store_true",
                    help="serve Inception images through the Neural Cache "
                         "emulation (the only serving path of this package)")
    ap.add_argument("--full", action="store_true",
                    help="serve the full 299 px, 1001-class network instead "
                         "of the reduced configuration")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--no-overlap", action="store_true",
                    help="plan batches serial instead of double-buffered")
    ap.add_argument("--warmup-replan", action="store_true",
                    help="re-plan from the first batch's measured occupancy")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request latency SLO: batches sized by the "
                         "predicted p99 from the cycle model")
    args = ap.parse_args(argv)
    if not args.neural_cache:
        ap.error("only --neural-cache serving is available in this package")
    return _main_neural_cache(args)


if __name__ == "__main__":
    sys.exit(main())
