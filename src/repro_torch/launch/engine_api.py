"""Formal serving-engine API — the contract between a serving engine and a
router (the port of ``repro.launch.engine_api``'s :class:`Engine`).

Anything that implements :class:`Engine` can sit behind a router: it
submits and steps requests, reports ``stats``, ``queue_depth`` and
``batch_cap``, exposes its own calibrated ``latency_model``
(:class:`~repro_torch.core.slo.LatencyModel`) and says when it is free
(``ready_in``).  ``launch/serve.py``'s ``NCServingEngine`` implements it.
The reference's fake-clock ``SimulatedEngine`` is not part of this package
yet.
"""
from __future__ import annotations

import abc

__all__ = ["Engine"]


class Engine(abc.ABC):
    """Abstract serving engine the orchestrator routes batches to.

    Implementations must also carry a ``name`` (unique within a fleet), a
    ``latency_model`` attribute (:class:`~repro.core.slo.LatencyModel`),
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

