"""Multi-engine serving orchestrator (the port of
``repro.launch.orchestrator``).

The paper's throughput headline is per socket (§VI-C: one 35 MB LLC =
604 inf/s) and its scaling story is more sockets.  This module is the
serving half of that story: N :class:`~repro_torch.launch.engine_api.Engine`
sockets, possibly heterogeneous (different ``CacheGeometry``s, different
calibrated speeds), behind ONE global request queue and a router that picks
engine and batch jointly to maximize the SLO hit rate.

Routing rule (``router="latency"``):

1. Engines with a backlog are drained first; only free engines
   (``ready_in == 0``, empty internal queue) are dispatch candidates.
2. For each free engine, bisect its own calibrated
   :class:`~repro_torch.core.slo.LatencyModel` curve for the largest batch
   whose predicted p99 fits the oldest queued request's remaining budget
   (capped by ``batch_cap`` and the queue depth).
3. Pick the candidate maximizing ``(fits deadline, batch size, -p99)``.
4. If no free engine can meet the deadline but a busy one could after
   freeing (``ready_in + p99(1) <= budget``), hold and wait for it.
5. A shallow queue is held for more arrivals only while slack remains and
   the :class:`~repro_torch.core.slo.ArrivalRateEstimator` expects the
   target batch to fill inside that slack.

``router="round-robin"`` is the baseline: cycle over free engines, greedy
``batch_cap`` batches, no holds.

Requests keep their global arrival stamp through dispatch
(``engine.submit(req, now=req.arrival_t)``), so per-request latency spans
the orchestrator's queue wait and the engine's execution, and logits stay
bit-identical to a standalone ``nc_forward`` whichever engine serves a
batch: the router changes placement and batch sizes, never results.  This
module is plain Python over the engines; it launches nothing itself.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time

from repro_torch.core import slo as nc_slo
from repro_torch.launch.engine_api import Engine

__all__ = ["Orchestrator", "RouteDecision"]


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """One routing verdict (kept in ``Orchestrator.decisions``).

    ``engine`` is the chosen engine's name (None = no dispatch this
    tick); ``admit`` the batch popped from the global queue; ``target``
    the SLO-optimal batch for the chosen engine; ``budget_s`` the oldest
    request's remaining deadline budget (NaN with no SLO or empty
    queue); ``reason`` one of ``full`` / ``ragged-early`` / ``flush`` /
    ``greedy`` / ``floor`` (deadline already blown, dispatch the floor
    batch and record the miss) / ``hold`` (wait for arrivals) /
    ``wait-better`` (a busy engine will make the deadline, no free one
    will) / ``busy`` (no free engine) / ``round-robin``."""

    engine: str | None
    admit: int
    target: int
    budget_s: float
    reason: str


class Orchestrator:
    """Global queue + router over N :class:`Engine` sockets.

    ``engines`` need unique names.  ``slo_ms`` arms deadline routing and
    orchestrator-level SLO accounting (engines under an orchestrator are
    normally built WITHOUT their own ``slo_ms``: the orchestrator owns
    admission sizing and stamps ``slo_ok`` itself, so hits/misses are
    counted once, at the layer that owns the queue wait).  The clock is
    injectable (``now_fn`` + explicit ``now=``) exactly like the
    engines', so fleet behavior is testable on a fake clock.
    """

    def __init__(self, engines, *, slo_ms: float | None = None,
                 router: str = "latency",
                 hold_slack_ms: float | None = None,
                 now_fn=time.monotonic):
        engines = list(engines)
        if not engines:
            raise ValueError("orchestrator needs at least one engine")
        names = [e.name for e in engines]
        if len(set(names)) != len(names):
            raise ValueError(f"engine names must be unique, got {names}")
        if router not in ("latency", "round-robin"):
            raise ValueError(f"unknown router {router!r}")
        self.engines: list[Engine] = engines
        self.by_name = {e.name: e for e in engines}
        self.router = router
        self.slo_s = slo_ms / 1e3 if slo_ms is not None else None
        self.hold_slack_s = (hold_slack_ms / 1e3
                             if hold_slack_ms is not None
                             else (0.25 * self.slo_s) if self.slo_s else 0.0)
        self.now_fn = now_fn
        self.arrivals = nc_slo.ArrivalRateEstimator()
        # deque: traffic replay backlogs run thousands deep and pop from
        # the left once per dispatched request
        self.queue: collections.deque = collections.deque()
        self.completed: list = []
        self.failed: list = []
        self.decisions: list[RouteDecision] = []
        self.dispatched = {e.name: 0 for e in engines}  # batches routed
        self.slo_hits = 0
        self.slo_misses = 0
        self.steps = 0
        self._rr_next = 0
        self._acct = {e.name: (0, 0) for e in engines}

    # -- queue ---------------------------------------------------------------
    def submit(self, req, now: float | None = None) -> None:
        """Enqueue one request on the GLOBAL queue (arrival observed by
        the fleet-wide rate estimator)."""
        now = self.now_fn() if now is None else now
        req.arrival_t = now
        self.arrivals.observe(now)
        self.queue.append(req)

    @property
    def pending(self) -> int:
        """Requests not yet finished: global queue + engine backlogs."""
        return len(self.queue) + sum(e.queue_depth for e in self.engines)

    def next_event_s(self, now: float) -> float:
        """Earliest instant a busy engine frees (``now`` if none is busy)
        — the fake-clock event loop's wait target."""
        waits = [e.ready_in(now) for e in self.engines]
        waits = [w for w in waits if w > 0.0]
        return now + min(waits) if waits else now

    # -- accounting ----------------------------------------------------------
    def _account(self, eng: Engine) -> None:
        """Fold requests the engine finished since the last tick into the
        orchestrator ledger, stamping ``slo_ok`` here — the engine has no
        SLO of its own, and the deadline spans the global queue wait."""
        c0, f0 = self._acct[eng.name]
        for r in eng.completed[c0:]:
            if self.slo_s is not None:
                r.slo_ok = (r.latency_s is not None
                            and r.latency_s <= self.slo_s)
                if r.slo_ok:
                    self.slo_hits += 1
                else:
                    self.slo_misses += 1
            self.completed.append(r)
        for r in eng.failed[f0:]:
            if self.slo_s is not None:
                r.slo_ok = False
                self.slo_misses += 1
            self.failed.append(r)
        self._acct[eng.name] = (len(eng.completed), len(eng.failed))

    # -- one orchestrator tick -----------------------------------------------
    def step(self, now: float | None = None, *, flush: bool = False) -> bool:
        """Drain engine backlogs, then route at most one batch from the
        global queue.  Returns False when nothing moved (queue empty,
        every engine busy, or the router is holding)."""
        now = self.now_fn() if now is None else now
        progressed = False
        # a previously dispatched batch an engine deferred or split is
        # drained before new placement — no stranded requests, ever
        for e in self.engines:
            if e.queue_depth > 0 and e.ready_in(now) <= 0.0:
                if e.step(now, flush=True):
                    progressed = True
                self._account(e)
        if not self.queue:
            return progressed
        if self.router == "latency":
            decision = self._route_latency(now, flush)
        else:
            decision = self._route_round_robin(now, flush)
        self.decisions.append(decision)
        if decision.engine is None or decision.admit <= 0:
            return progressed
        eng = self.by_name[decision.engine]
        batch = [self.queue.popleft() for _ in range(decision.admit)]
        for r in batch:
            # preserve the global arrival stamp: queue wait spans the
            # orchestrator queue, not just the engine's
            eng.submit(r, now=r.arrival_t)
        self.dispatched[decision.engine] += 1
        if eng.step(now, flush=True):
            progressed = True
        self._account(eng)
        self.steps += 1
        return progressed

    # -- routers -------------------------------------------------------------
    def _budget(self, now: float) -> float:
        if self.slo_s is None:
            return math.inf
        return self.slo_s - (now - self.queue[0].arrival_t)

    def _free(self, now: float) -> list[Engine]:
        return [e for e in self.engines
                if e.ready_in(now) <= 0.0 and e.queue_depth == 0]

    def _route_latency(self, now: float, flush: bool) -> RouteDecision:
        queued = len(self.queue)
        budget = self._budget(now)
        free = self._free(now)
        if not free:
            return RouteDecision(None, 0, 0,
                                 budget if math.isfinite(budget)
                                 else float("nan"), "busy")
        if math.isinf(budget):
            # no SLO: amortize the filter load over the biggest batch,
            # finish soonest on ties
            best = max(free, key=lambda e: (
                min(e.batch_cap, queued),
                -e.latency_model.predict_p99_s(min(e.batch_cap, queued))))
            n = min(best.batch_cap, queued)
            return RouteDecision(best.name, n, n, float("nan"), "greedy")
        clamped = max(budget, 0.0)
        best = None  # (fits, n, -p99, engine, target)
        for e in free:
            policy = nc_slo.AdmissionPolicy(e.latency_model, self.slo_s,
                                            e.batch_cap)
            target = policy.target_batch(clamped)
            n = min(target, queued)
            p99 = e.latency_model.predict_p99_s(n)
            key = (p99 <= budget, n, -p99)
            if best is None or key > best[0]:
                best = (key, e, n, target, p99)
        key, eng, n, target, p99 = best
        fits = key[0]
        if flush:
            return RouteDecision(eng.name, n, target, budget, "flush")
        if not fits:
            # every free engine misses the deadline — a busy engine that
            # would still make it after freeing is worth waiting for
            for o in self.engines:
                wait = o.ready_in(now)
                if (wait > 0.0 and
                        wait + o.latency_model.predict_p99_s(1) <= budget):
                    return RouteDecision(None, 0, target, budget,
                                         "wait-better")
            return RouteDecision(eng.name, n, target, budget, "floor")
        if queued >= target:
            return RouteDecision(eng.name, target, target, budget, "full")
        slack = budget - eng.latency_model.predict_p99_s(queued)
        if slack <= self.hold_slack_s:
            return RouteDecision(eng.name, queued, target, budget,
                                 "ragged-early")
        fill = self.arrivals.expected_fill_time_s(target - queued)
        if fill is not None and fill >= slack:
            return RouteDecision(eng.name, queued, target, budget,
                                 "ragged-early")
        return RouteDecision(None, 0, target, budget, "hold")

    def _route_round_robin(self, now: float, flush: bool) -> RouteDecision:
        budget = self._budget(now)
        budget = budget if math.isfinite(budget) else float("nan")
        free = set(id(e) for e in self._free(now))
        if not free:
            return RouteDecision(None, 0, 0, budget, "busy")
        for k in range(len(self.engines)):
            idx = (self._rr_next + k) % len(self.engines)
            e = self.engines[idx]
            if id(e) in free:
                self._rr_next = (idx + 1) % len(self.engines)
                n = min(e.batch_cap, len(self.queue))
                return RouteDecision(e.name, n, n, budget, "round-robin")
        return RouteDecision(None, 0, 0, budget, "busy")

    # -- draining ------------------------------------------------------------
    def run(self):
        """Drain everything with ``flush=True`` (no more arrivals are
        coming): every submitted request ends in ``completed`` or
        ``failed`` — none stranded in the global queue or any engine.
        Synchronous fleets drain in one pass; fake-clock fleets busy-wait
        ``now_fn`` up to the next engine-free instant."""
        frozen = 0
        last_now = None
        while self.pending:
            now = self.now_fn()
            if self.step(now=now, flush=True):
                frozen = 0
            elif last_now is not None and now <= last_now:
                frozen += 1
                if frozen > 100_000:
                    raise RuntimeError(
                        "orchestrator stalled: engines busy but the clock "
                        "never advances — fake-clock fleets must drive "
                        "step(now=...) from their own event loop")
            last_now = now
        return self.completed

    def stats(self) -> dict:
        """Fleet snapshot: orchestrator-level accounting + per-engine
        stats under their names."""
        total = self.slo_hits + self.slo_misses
        hist: dict[int, int] = {}
        for e in self.engines:
            for n, c in getattr(e, "batch_histogram", {}).items():
                hist[n] = hist.get(n, 0) + c
        return dict(
            router=self.router,
            steps=self.steps,
            queue_depth=len(self.queue),
            completed=len(self.completed),
            failed=len(self.failed),
            slo_ms=self.slo_s * 1e3 if self.slo_s is not None else None,
            slo_hits=self.slo_hits,
            slo_misses=self.slo_misses,
            slo_hit_rate=self.slo_hits / total if total else None,
            batch_histogram=dict(sorted(hist.items())),
            dispatched=dict(self.dispatched),
            arrival_rate_hz=self.arrivals.rate_hz,
            engines={e.name: e.stats() for e in self.engines},
        )
