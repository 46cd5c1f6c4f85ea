"""Formal serving-engine API — the contract between a serving engine and a
router (the port of ``repro.launch.engine_api``'s :class:`Engine`).

Anything that implements :class:`Engine` can sit behind a router: it
submits and steps requests, reports ``stats``, ``queue_depth`` and
``batch_cap``, exposes its own calibrated ``latency_model``
(:class:`~repro_torch.core.slo.LatencyModel`) and says when it is free
(``ready_in``).  Two implementations ship: ``launch/serve.py``'s
``NCServingEngine`` (the bit-serial emulation on the device; synchronous,
so ``ready_in`` is always 0) and :class:`SimulatedEngine` below (fake-clock
execution over the same priced plans, for traffic replay and capacity
planning).  ``launch/orchestrator.py`` routes a global queue over N of
them.
"""
from __future__ import annotations

import abc
import dataclasses

import numpy as np

from repro_torch.core import slo as nc_slo

__all__ = ["Engine", "SimulatedEngine", "SimRequest"]


class Engine(abc.ABC):
    """Abstract serving engine the orchestrator routes batches to.

    Implementations must also carry a ``name`` (unique within a fleet), a
    ``latency_model`` attribute (:class:`~repro_torch.core.slo.LatencyModel`),
    and the ``completed``/``failed`` request lists the orchestrator
    accounts from.  The request objects flowing through are duck-typed:
    ``arrival_t``, ``latency_s``, ``slo_ok``, ``done``, ``failed``
    (``serve.NCRequest`` and :class:`SimRequest` both qualify).
    """

    name: str

    @abc.abstractmethod
    def submit(self, req, now: float | None = None) -> None:
        """Enqueue one request, stamping ``req.arrival_t`` (pass ``now=``
        to preserve an arrival stamped by an upstream global queue)."""

    @abc.abstractmethod
    def step(self, now: float | None = None, *, flush: bool = False) -> bool:
        """Admit and execute one batch; False when nothing was admitted.
        ``flush=True`` disables any hold-for-arrivals behavior."""

    @abc.abstractmethod
    def stats(self) -> dict:
        """Accounting snapshot (steps, completed, failed, histogram, …)."""

    @property
    @abc.abstractmethod
    def queue_depth(self) -> int:
        """Requests owned by the engine but not yet executed."""

    @property
    @abc.abstractmethod
    def batch_cap(self) -> int:
        """Hard admission bound (engine limit ∧ stream_batch_limit)."""

    def ready_in(self, now: float) -> float:
        """Seconds until a new batch can start (0.0 = free now).
        Synchronous engines execute inside ``step()`` and are always
        free; fake-clock engines report their busy horizon."""
        return 0.0



@dataclasses.dataclass
class SimRequest:
    """Minimal request for fake-clock replay (duck-types ``NCRequest``'s
    accounting fields without carrying an image)."""

    rid: int
    arrival_t: float = 0.0
    latency_s: float | None = None
    slo_ok: bool | None = None
    done: bool = False
    failed: bool = False


class SimulatedEngine(Engine):
    """Fake-clock engine over the same priced plans a real socket serves.

    Admission, calibration and accounting run the real code paths (a
    :class:`~repro_torch.core.slo.LatencyModel` over ``schedule_for`` and,
    with ``slo_ms``, an :class:`~repro_torch.core.slo.AdmissionPolicy`);
    only execution is simulated: ``step()`` takes the batch wall as
    ``true_scale`` x the modeled batch time (x a seeded, bounded jitter),
    marks the engine busy until ``now + wall`` and stamps completion at that
    instant.  The latency model learns ``true_scale`` from the simulated
    walls as it would from measured ones.

    The jitter draws from ``np.random.default_rng(seed)``, the reference's
    generator, so a seeded replay matches the reference draw for draw.
    """

    def __init__(self, name: str, schedule_for, *, max_batch: int = 4,
                 slo_ms: float | None = None,
                 hold_slack_ms: float | None = None,
                 true_scale: float = 1.0, jitter: float = 0.0,
                 seed: int = 0, const=None,
                 arrivals: nc_slo.ArrivalRateEstimator | None = None):
        self.name = name
        self.queue: list = []
        self.completed: list = []
        self.failed: list = []
        self.steps = 0
        self.max_batch = max_batch
        self.latency_model = nc_slo.LatencyModel(schedule_for, const=const)
        self.slo_s = slo_ms / 1e3 if slo_ms is not None else None
        self.policy = None
        if self.slo_s is not None:
            self.policy = nc_slo.AdmissionPolicy(
                self.latency_model, self.slo_s, max_batch,
                hold_slack_s=(hold_slack_ms / 1e3
                              if hold_slack_ms is not None else None),
                arrivals=arrivals)
        self.true_scale = float(true_scale)
        self.jitter = float(jitter)
        self._rng = np.random.default_rng(seed)
        self.busy_until = 0.0
        self.decisions: list = []
        self.batch_histogram: dict[int, int] = {}
        self.slo_hits = 0
        self.slo_misses = 0

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def batch_cap(self) -> int:
        if self.policy is not None:
            return self.policy.batch_cap
        return max(1, min(self.max_batch,
                          self.latency_model.stream_batch_limit))

    def ready_in(self, now: float) -> float:
        return max(0.0, self.busy_until - now)

    def submit(self, req, now: float | None = None) -> None:
        req.arrival_t = 0.0 if now is None else now
        self.queue.append(req)

    def step(self, now: float | None = None, *, flush: bool = False) -> bool:
        now = self.busy_until if now is None else now
        if not self.queue or now < self.busy_until:
            return False
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
        wall = self.true_scale * self.latency_model.modeled_batch_s(n)
        if self.jitter:
            wall *= 1.0 + self.jitter * float(self._rng.uniform(-1.0, 1.0))
        self.busy_until = now + wall
        # the simulated wall calibrates the model like a measured one
        self.latency_model.observe(n, wall)
        self.batch_histogram[n] = self.batch_histogram.get(n, 0) + 1
        for r in batch:
            r.latency_s = (now - r.arrival_t) + wall
            r.done = True
            if self.slo_s is not None:
                r.slo_ok = r.latency_s <= self.slo_s
                if r.slo_ok:
                    self.slo_hits += 1
                else:
                    self.slo_misses += 1
            self.completed.append(r)
        self.steps += 1
        return True

    def stats(self) -> dict:
        total = self.slo_hits + self.slo_misses
        return dict(
            steps=self.steps,
            completed=len(self.completed),
            failed=len(self.failed),
            batch_histogram=dict(sorted(self.batch_histogram.items())),
            slo_hits=self.slo_hits,
            slo_misses=self.slo_misses,
            slo_hit_rate=self.slo_hits / total if total else None,
            calibration_scale=self.latency_model.scale,
            calibration_samples=self.latency_model.samples,
            stream_batch_limit=self.latency_model.stream_batch_limit,
            busy_until=self.busy_until,
        )
