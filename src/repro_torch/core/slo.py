"""SLO-aware serving control: the cycle model as the admission input.

The paper's throughput claims (§VI-C, Figure 13/16) assume batches sized so
filters stay resident while images stream.  Production inference, though, is
governed by tail-latency bounds, not raw throughput (Jouppi et al., the TPU
datacenter paper: requests carry a 99th-percentile deadline and the server
picks the largest batch that still meets it).  This module closes that loop
for the Neural Cache serving path: the simulator stops being a reporting
tool and becomes the control input for admission.

Two pieces:

* :class:`LatencyModel` — converts a :class:`~repro.core.schedule.
  NetworkSchedule`'s modeled cycles (priced by ``simulator.batch_time_s``:
  filter load once per batch + per-image marginal + §IV-E spill, minus the
  filter-load time hidden by double-buffered plans — schedules planned
  with ``overlap=True`` automatically price the overlapped pipeline, so
  the serving engine's default plans calibrate against overlapped
  predictions with no changes here) into a
  predicted wall-latency curve ``latency(batch)``.  The modeled number is
  hardware time; the emulation (or a real deployment) runs at some
  process-dependent multiple of it, so the model *calibrates*: every
  executed batch reports its measured wall time via :meth:`~LatencyModel.
  observe`, and the running wall/modeled ratio (EWMA) scales predictions.
  The p99 prediction multiplies by the worst *recently* observed ratio
  (a sliding window, so cold-compile/CPU-steal outliers age out; never
  thinner than a safety margin over the mean), so one calibration scalar
  serves every batch size — predictions stay strictly monotone in
  ``batch`` by construction, an invariant
  ``benchmarks/sched_breakdown.py`` gates.

* :class:`AdmissionPolicy` — given a target SLO, picks the largest batch
  whose predicted p99 stays under the *remaining* budget of the oldest
  queued request (queue wait has already spent part of it), bounded by
  ``NetworkSchedule.stream_batch_limit`` (batches past it spill, and the
  spill cost is already inside the predicted latency, so the model
  penalizes them even before the hard cap bites) and the engine's
  ``max_batch``.  Ragged tails are admitted *early* once holding for a
  fuller batch would eat into the oldest request's deadline slack
  (:meth:`~AdmissionPolicy.admit` reasons: ``full`` / ``ragged-early`` /
  ``hold`` / ``flush``).

* :class:`ArrivalRateEstimator` — an
  EWMA over observed inter-arrival intervals.  Wired into a policy
  (``arrivals=``), the hold decision stops being slack-only: a shallow
  queue is held *only while the estimated time to fill the target batch
  fits inside the remaining slack* — under sparse traffic the expected
  fill time exceeds the slack immediately and the ragged batch flushes
  early instead of burning deadline budget waiting for arrivals that are
  not coming.

Consumed by ``launch/serve.py::NCServingEngine`` (``--slo-ms``), which
shares its per-batch-size plan cache with the model so admission decisions
and execution price the very same :class:`NetworkSchedule` objects, and by
``launch/orchestrator.py``, which routes a global queue across N engines
by each engine's own calibrated model (one estimator per orchestrator).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

from repro_torch.core.schedule import NetworkSchedule
from repro_torch.core.simulator import (NetworkResult, SimConstants, batch_time_s,
                                  simulate_network)

__all__ = ["LatencyModel", "AdmissionDecision", "AdmissionPolicy",
           "ArrivalRateEstimator"]


class ArrivalRateEstimator:
    """EWMA inter-arrival estimator.

    ``observe(now)`` is called once per arriving request with the engine
    clock; the estimator keeps an EWMA of the inter-arrival intervals.
    ``expected_fill_time_s(k)`` answers the question the hold decision
    actually asks — "how long until ``k`` more requests show up?" — as
    ``k * mean_interval``.  With fewer than two arrivals there is no
    interval information yet and it returns ``None`` (callers fall back
    to the slack-only hold rule).
    """

    def __init__(self, ewma: float = 0.3):
        self.ewma = float(ewma)
        self.mean_interval_s: float | None = None
        self._last_t: float | None = None
        self.samples = 0  # arrivals observed (intervals = samples - 1)

    def observe(self, now: float) -> None:
        """Fold one arrival timestamp in (monotone engine-clock time)."""
        if self._last_t is not None:
            dt = max(now - self._last_t, 0.0)
            if self.mean_interval_s is None:
                self.mean_interval_s = dt
            else:
                self.mean_interval_s = (self.ewma * dt
                                        + (1.0 - self.ewma)
                                        * self.mean_interval_s)
        self._last_t = now
        self.samples += 1

    @property
    def rate_hz(self) -> float | None:
        """Estimated arrival rate (None until two arrivals were seen)."""
        if self.mean_interval_s is None:
            return None
        return 1.0 / max(self.mean_interval_s, 1e-12)

    def expected_fill_time_s(self, k: int) -> float | None:
        """Expected seconds until ``k`` further requests arrive (None
        when the rate is still unknown)."""
        if k <= 0:
            return 0.0
        if self.mean_interval_s is None:
            return None
        return k * self.mean_interval_s


class LatencyModel:
    """Predicted serving latency per batch size from the priced plan.

    ``schedule_for(n)`` supplies the :class:`NetworkSchedule` for batch
    ``n`` — pass the serving engine's cached planner so the model and the
    execution path share plan objects (one source of truth).  Results are
    priced once per batch size and memoized.

    Calibration: ``observe(batch, wall_s)`` folds a measured batch wall
    time into the running wall/modeled ratio.  ``predict_s`` scales the
    modeled batch time by that EWMA ratio; ``predict_p99_s`` scales by the
    worst ratio over the last ``window`` observations, floored at
    ``tail_safety`` times the mean — a pessimistic tail estimate.  The
    window matters: the very first observation of a batch size includes
    one-time jit compilation, and shared hosts show transient CPU-steal
    spikes; a windowed max lets such outliers age out instead of capping
    admitted batch sizes for the engine's lifetime.  Uncalibrated models
    predict modeled (hardware) time times the safety margin.

    Invariant (gated by ``benchmarks/sched_breakdown.py`` and
    ``tests/test_serving_slo.py``): both predictions are strictly
    increasing in ``batch`` — the calibration is a batch-independent
    scalar over ``batch_time_s``, which is affine increasing in the batch.
    """

    def __init__(self, schedule_for: Callable[[int], NetworkSchedule],
                 const: SimConstants | None = None,
                 tail_safety: float = 1.25,
                 ewma: float = 0.5,
                 window: int = 32):
        self._schedule_for = schedule_for
        self._const = const or SimConstants()
        self._results: dict[int, NetworkResult] = {}
        self.tail_safety = float(tail_safety)
        self.ewma = float(ewma)
        self.scale = 1.0  # EWMA of observed wall_s / modeled_batch_s
        self._recent = collections.deque(maxlen=window)  # recent ratios
        self.samples = 0
        self.excluded = 0  # degraded/fallback batches kept out of calibration

    # -- modeled (hardware) time --------------------------------------------
    def result_for(self, batch: int) -> NetworkResult:
        """The priced :class:`NetworkResult` for ``batch`` (memoized; the
        schedule comes from the shared ``schedule_for`` plan cache)."""
        if batch not in self._results:
            self._results[batch] = simulate_network(
                self._schedule_for(batch), const=self._const)
        return self._results[batch]

    def invalidate_plans(self) -> None:
        """Drop every memoized priced result — call after the serving
        engine re-plans (warmup re-planning replaces the schedule
        cache behind ``schedule_for``), so predictions re-price the NEW
        plans instead of serving a stale curve.  Calibration observations
        are kept: the wall/modeled scale tracks host effects, not the
        plan shape (the re-planner excludes the one batch that executed
        the retired plan)."""
        self._results.clear()

    def reset_calibration(self) -> None:
        """Forget every measured wall/modeled observation — call when the
        execution BACKEND changes (``NCServingEngine.set_engine``).
        The wall-clock-per-modeled-cycle scale is a property of the
        execution body (host walk vs bucketed jit vs Pallas interpret),
        so observations from one backend must not price another; modeled
        cycles themselves are backend-invariant and the priced-plan memo
        is handled separately by :meth:`invalidate_plans`."""
        self.scale = 1.0
        self.samples = 0
        self._recent.clear()

    def modeled_batch_s(self, batch: int) -> float:
        """Modeled time to run one admitted batch: filter load once +
        ``batch`` x (marginal + spill) — ``simulator.batch_time_s``."""
        return batch_time_s(self.result_for(batch), batch)

    @property
    def stream_batch_limit(self) -> int:
        """The §VI-C streaming bound of the planned network (images the
        reserved I/O way stages at once).  Pruning-independent for
        uncompressed plans; compressed plans may stage deeper —
        see ``NetworkSchedule.stream_batch_limit``."""
        return self._schedule_for(1).stream_batch_limit

    # -- calibration ---------------------------------------------------------
    @property
    def calibrated(self) -> bool:
        return self.samples > 0

    def observe(self, batch: int, wall_s: float) -> float:
        """Fold one measured batch wall time into the calibration; returns
        the observed wall/modeled ratio."""
        ratio = wall_s / self.modeled_batch_s(batch)
        if self.samples == 0:
            self.scale = ratio
        else:
            self.scale = self.ewma * ratio + (1.0 - self.ewma) * self.scale
        self._recent.append(ratio)
        self.samples += 1
        return ratio

    def exclude(self, batch: int, wall_s: float) -> None:
        """Explicitly keep one measured batch OUT of the calibration.

        Fault-degraded batches (a fallback schedule, or the float reference
        path) do not execute the plan the model prices, so folding their
        wall time into the wall/modeled ratio would poison every later
        prediction.  The engine calls this instead of :meth:`observe` for
        such batches — the exclusion is recorded (``excluded``) so the
        accounting in ``stats()`` stays honest, and ``scale``/``samples``/
        the tail window are untouched."""
        self.excluded += 1

    @property
    def worst(self) -> float:
        """Worst wall/modeled ratio over the last ``window`` observations
        (windowed so a cold-compile or CPU-steal outlier ages out)."""
        return max(self._recent, default=0.0)

    @property
    def p99_scale(self) -> float:
        """Tail multiplier: worst recent observed ratio, never thinner
        than ``tail_safety`` x the running mean."""
        return max(self.worst, self.scale * self.tail_safety)

    # -- predictions ---------------------------------------------------------
    def predict_s(self, batch: int) -> float:
        """Expected wall time for an admitted batch of ``batch`` images."""
        return self.scale * self.modeled_batch_s(batch)

    def predict_p99_s(self, batch: int) -> float:
        """Tail (p99) wall time for an admitted batch of ``batch`` images."""
        return self.p99_scale * self.modeled_batch_s(batch)

    def curve(self, batches) -> list[tuple[int, float, float]]:
        """``[(batch, predict_s, predict_p99_s), ...]`` for reporting."""
        return [(b, self.predict_s(b), self.predict_p99_s(b))
                for b in batches]


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """One admission verdict (kept by the engine for stats/tests).

    ``admit`` is the number of requests to pop now (0 = keep holding for a
    fuller batch); ``target`` the SLO-optimal batch size for the current
    budget; ``budget_s`` the oldest queued request's remaining deadline
    budget (``float("nan")`` when the queue is empty — no oldest request,
    no budget); ``reason`` one of ``full`` (queue covers the target),
    ``ragged-early`` (deadline pressure flushed a partial batch),
    ``flush`` (caller forced draining) or ``hold``."""

    admit: int
    target: int
    budget_s: float
    reason: str


@dataclasses.dataclass
class AdmissionPolicy:
    """SLO-aware batch sizing over a :class:`LatencyModel`.

    ``slo_s`` is the per-request deadline (arrival to completion).  The
    policy never admits more than ``batch_cap`` = min(``max_batch``,
    ``stream_batch_limit``) requests at once, and never *targets* a batch
    whose predicted p99 exceeds the remaining budget.  ``hold_slack_s``
    is how much deadline slack a partial batch may retain before the
    policy keeps holding for more arrivals (default: a quarter of the
    SLO).  ``arrivals`` (optional) is an
    :class:`ArrivalRateEstimator`: when set, a shallow queue is held only
    while the estimated time to fill the target batch fits inside the
    remaining slack — sparse traffic flushes ragged batches immediately
    instead of holding until the slack rule fires."""

    model: LatencyModel
    slo_s: float
    max_batch: int
    hold_slack_s: float | None = None
    arrivals: ArrivalRateEstimator | None = None

    @property
    def hold_slack(self) -> float:
        return (self.hold_slack_s if self.hold_slack_s is not None
                else 0.25 * self.slo_s)

    @property
    def batch_cap(self) -> int:
        """Hard admission bound: the engine's batch limit and the §VI-C
        streaming bound, whichever bites first."""
        return max(1, min(self.max_batch, self.model.stream_batch_limit))

    def target_batch(self, budget_s: float) -> int:
        """Largest batch in [1, batch_cap] whose predicted p99 fits the
        budget; 1 when even a single image cannot (admit the smallest
        batch and take the recorded miss rather than starving).  Found by
        bisection — predictions are monotone in the batch."""
        cap = self.batch_cap
        if self.model.predict_p99_s(1) > budget_s:
            return 1
        lo, hi = 1, cap  # predict_p99_s(lo) <= budget_s invariant
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.model.predict_p99_s(mid) <= budget_s:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def admit(self, queued: int, oldest_wait_s: float,
              flush: bool = False) -> AdmissionDecision:
        """Decide how many of ``queued`` requests to admit now.

        ``oldest_wait_s`` is how long the head-of-line request has already
        queued — its remaining budget bounds the batch.  A queue at least
        as deep as the target admits immediately; a shallower (ragged)
        queue is held for more arrivals until its remaining slack after
        execution would drop below ``hold_slack``, then admitted early so
        the deadline survives.  With an ``arrivals`` estimator the hold
        is additionally bounded by traffic: holding is only worth it if
        the expected time to fill the target batch fits inside the slack.
        ``flush=True`` (draining: no more arrivals are coming) disables
        holding but keeps the SLO batch cap.

        An empty queue holds trivially; there is no oldest request, so no
        deadline budget exists — ``budget_s`` is reported as
        ``float("nan")``, not a number pretending to be one."""
        if queued <= 0:
            return AdmissionDecision(0, 0, float("nan"), "hold")
        budget = self.slo_s - oldest_wait_s
        target = self.target_batch(max(budget, 0.0))
        if queued >= target:
            return AdmissionDecision(target, target, budget, "full")
        if flush:
            return AdmissionDecision(queued, target, budget, "flush")
        slack = budget - self.model.predict_p99_s(queued)
        if slack <= self.hold_slack:
            return AdmissionDecision(queued, target, budget, "ragged-early")
        if self.arrivals is not None:
            # holding only pays off if the missing requests are expected
            # to show up before the slack runs out; unknown rate (fewer
            # than two arrivals seen) falls back to the slack-only rule
            fill = self.arrivals.expected_fill_time_s(target - queued)
            if fill is not None and fill >= slack:
                return AdmissionDecision(queued, target, budget,
                                         "ragged-early")
        return AdmissionDecision(0, target, budget, "hold")
