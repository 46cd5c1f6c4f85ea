"""Deterministic fault injection for the bit-serial emulation.

The port of ``repro.core.faults``.  Neural Cache computes by activating two
word lines against sense-amp margins, so the failure modes injected here
are transient bit-flips in the packed SRAM residency, stuck-at word lines
and whole-pass compute corruption:

* :class:`FaultProfile`: frozen, seed-threaded description of the fault
  environment (rates per fault class, stuck slices, stall injection).
* :class:`FaultState`: live injection state scoped by :func:`inject`.
  Every random draw comes from a numpy generator keyed by
  ``(seed, class, layer, pass)`` through CRC32, exactly as the reference
  draws it, so the same profile corrupts the same words in both packages,
  whatever the execution order, retries or batch size.
* Transient classes (filter/activation flips, compute corruption, stalls)
  fire at most once per ``(class, layer, pass)`` site: the first attempt at
  the site is corrupted and re-executions are clean.  Stuck-at faults
  persist until the slice is quarantined (:meth:`FaultState.quarantine`).

Injection targets only live lanes (the caller passes them), so every
injected fault changes the output and "zero silent corruption" is the
exact equality ``corrupt_attempts == detected``.

The corruption functions take the port's word tensors (int64 holding
32-bit words) and value tensors on their device and return either the
same object (nothing fired) or a corrupted copy: the resident grids are
never mutated.  The decisions are made on the host with numpy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import zlib
from typing import Iterator, Optional

import numpy as np
import torch

__all__ = [
    "FaultProfile",
    "FaultState",
    "IntegrityError",
    "inject",
    "active",
    "COVERED_CLASSES",
]

# fault classes the integrity layer detects with certainty (stalls only
# perturb wall time: there is nothing to detect)
COVERED_CLASSES = ("filter_flip", "act_flip", "compute", "stuck")

_WORD_MASK = 0xFFFFFFFF


class IntegrityError(RuntimeError):
    """A pass failed verification beyond the retry and quarantine budget."""

    def __init__(self, layer: str, pass_index: int, attempts: int):
        super().__init__(
            f"integrity failure in layer {layer!r}, pass {pass_index}: "
            f"still corrupt after {attempts} attempts and slice quarantine")
        self.layer = layer
        self.pass_index = pass_index
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """Seed-threaded fault environment.  Rates are per (layer, pass) site
    probabilities; ``stuck_slices`` lists slice ids whose resident filter
    words are persistently corrupted until quarantined."""

    seed: int = 0
    filter_flip_rate: float = 0.0   # transient bit-flip in packed filter words
    act_flip_rate: float = 0.0      # transient bit-flip in packed window words
    compute_rate: float = 0.0       # whole-pass compute corruption
    stall_rate: float = 0.0         # per-pass latency stall probability
    stall_s: float = 0.0            # injected stall duration (seconds)
    stuck_slices: tuple = ()        # slice ids with stuck-at word lines
    n_slices: int = 14              # slice pool the pass->slice map hashes over
    max_retries: int = 3            # bounded re-execution budget per pass

    def __post_init__(self):
        for f in ("filter_flip_rate", "act_flip_rate", "compute_rate",
                  "stall_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f}={v} outside [0, 1]")
        stuck = tuple(sorted(set(int(s) for s in self.stuck_slices)))
        object.__setattr__(self, "stuck_slices", stuck)
        if any(s < 0 or s >= self.n_slices for s in stuck):
            raise ValueError(f"stuck slice out of range: {stuck}")
        if len(stuck) >= self.n_slices:
            raise ValueError("every slice stuck: nothing could ever verify")

    @classmethod
    def parse(cls, spec: str) -> "FaultProfile":
        """Parse a CLI spec like ``seed=7,filter=0.05,act=0.01,compute=0.01,
        stuck=2+5,stall=0.1:0.002``.  ``stuck`` takes ``+``-separated slice
        ids; ``stall`` takes ``rate`` or ``rate:seconds``."""
        kw: dict = {}
        alias = {"filter": "filter_flip_rate", "act": "act_flip_rate",
                 "compute": "compute_rate"}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"bad fault-profile field {part!r} "
                                 f"(expected key=value)")
            key, val = part.split("=", 1)
            key = key.strip()
            if key in ("seed", "n_slices", "max_retries"):
                kw[key] = int(val)
            elif key in alias:
                kw[alias[key]] = float(val)
            elif key == "stuck":
                kw["stuck_slices"] = tuple(
                    int(s) for s in val.split("+") if s)
            elif key == "stall":
                rate, _, dur = val.partition(":")
                kw["stall_rate"] = float(rate)
                kw["stall_s"] = float(dur) if dur else 0.001
            else:
                raise ValueError(f"unknown fault-profile key {key!r}")
        return cls(**kw)

    @property
    def any_faults(self) -> bool:
        return bool(self.filter_flip_rate or self.act_flip_rate
                    or self.compute_rate or self.stall_rate
                    or self.stuck_slices)


def _site_key(*parts) -> int:
    return zlib.crc32(":".join(str(p) for p in parts).encode())


class FaultState:
    """Live injection state for one :func:`inject` scope.

    Counters (all in :meth:`stats`): ``injected`` (fault events applied,
    each output-changing), ``corrupt_attempts`` (pass executions that ran
    with at least one event), ``detected`` (verification mismatches the
    integrity layer caught), ``reexecuted`` (bounded pass re-executions),
    ``stalls`` / ``stall_s_total`` (injected latency events)."""

    def __init__(self, profile: FaultProfile):
        self.profile = profile
        self.quarantined: set = set()
        self.events: list = []
        self.injected = 0
        self.corrupt_attempts = 0
        self.detected = 0
        self.reexecuted = 0
        self.stalls = 0
        self.stall_s_total = 0.0
        self._fired: set = set()

    # -- deterministic randomness ------------------------------------------
    def _site_rng(self, cls: str, layer: str, pass_index: int):
        return np.random.default_rng(
            (int(self.profile.seed) << 32) ^ _site_key(cls, layer, pass_index))

    def _transient(self, cls: str, rate: float, layer: str,
                   pass_index: int) -> Optional[np.random.Generator]:
        """One-shot site draw: a site generator when the transient fault
        fires (first execution of the site only), else None."""
        if rate <= 0.0:
            return None
        site = (cls, layer, pass_index)
        if site in self._fired:
            return None
        rng = self._site_rng(cls, layer, pass_index)
        if rng.random() >= rate:
            return None
        self._fired.add(site)
        return rng

    # -- pass -> slice map --------------------------------------------------
    def live_slices(self) -> list:
        return [s for s in range(self.profile.n_slices)
                if s not in self.quarantined]

    def slice_for(self, layer: str, pass_index: int) -> Optional[int]:
        """Deterministic pass->slice residency map over the live slices; it
        shifts when a slice is quarantined."""
        live = self.live_slices()
        if not live:
            return None
        return live[_site_key("slice", layer, pass_index) % len(live)]

    def quarantine(self, sid: int) -> None:
        if sid not in self.quarantined:
            self.quarantined.add(int(sid))
            self.events.append(("quarantine", "", int(sid), 0, 0, 0))

    # -- corruption ---------------------------------------------------------
    def _log(self, cls: str, layer: str, pass_index: int, *detail) -> None:
        d = tuple(int(x) for x in detail) + (0,) * (3 - len(detail))
        self.events.append((cls, layer, int(pass_index)) + d)
        self.injected += 1

    def corrupt_filter_words(self, ww: torch.Tensor, layer: str,
                             pass_index: int, *, lanes, filters: int, P: int,
                             r: int) -> torch.Tensor:
        """Return ``ww`` or a corrupted copy.  ``lanes`` are the live lane
        indices (host integers) and ``filters`` bounds the live filter rows,
        so any flip here changes the pass's output.  The grid layout is
        ``nc_layers._pack_w_rows``'s: ``(n, M, 1, words_per_row)`` when
        ``r == 1``, else ``(n, M, 1)`` with ``r`` replicas of ``P`` lanes
        per word."""
        lanes = np.asarray(lanes)
        if lanes.size == 0 or filters <= 0:
            return ww
        out = ww
        n_planes = ww.shape[0]
        n_filters = min(int(filters), ww.shape[1])

        rng = self._transient("filter_flip", self.profile.filter_flip_rate,
                              layer, pass_index)
        if rng is not None:
            k = int(lanes[rng.integers(lanes.size)])
            m = int(rng.integers(n_filters))
            p = int(rng.integers(n_planes))
            out = out.clone()
            if r == 1:
                out[p, m, 0, k // 32] ^= 1 << (k % 32)
            else:
                out[p, m, 0] ^= 1 << k  # replica 0 of lane k
            self._log("filter_flip", layer, pass_index, p, m, k)

        sid = self.slice_for(layer, pass_index)
        if sid is not None and sid in self.profile.stuck_slices:
            hit = self._stuck_hit(out, lanes, n_filters, r,
                                  layer, pass_index)
            if hit is not None:
                p, m, k = hit
                if out is ww:
                    out = out.clone()
                if r == 1:
                    out[p, m, 0, k // 32] |= _WORD_MASK
                else:
                    out[p, m, 0] |= _WORD_MASK
                self._log("stuck", layer, pass_index, p, m, k)
        return out

    def _stuck_hit(self, ww: torch.Tensor, lanes: np.ndarray, n_filters: int,
                   r: int, layer: str, pass_index: int):
        """A (plane, filter, lane) whose bit is 0 at a live lane, so the
        monotone whole-word stuck-at-1 provably changes the output.
        Deterministic per site; None when every live bit is already set."""
        rng = self._site_rng("stuck_pos", layer, pass_index)
        n_planes = ww.shape[0]
        words = ww.cpu()  # the search reads single words: do it on the host
        order_k = rng.permutation(lanes.size)
        for ki in order_k[:8]:
            k = int(lanes[ki])
            for m in rng.permutation(n_filters)[:4]:
                m = int(m)
                for p in range(n_planes):
                    if r == 1:
                        word = int(words[p, m, 0, k // 32])
                        bit = 1 << (k % 32)
                    else:
                        word = int(words[p, m, 0])
                        bit = 1 << k
                    if not word & bit:
                        return p, m, k
        return None

    def corrupt_act_words(self, xw: torch.Tensor, layer: str, pass_index: int,
                          *, lanes, rows: int, P: int, r: int) -> torch.Tensor:
        """Transient bit-flip in the packed activation (window) words.
        ``lanes`` are lanes where some live filter is nonzero, so the flip
        changes that filter's output for the flipped row.  The grid layout
        is ``nc_layers._pack_x_rows``'s: ``(n, 1, T, words_per_row)`` when
        ``r == 1``, else ``(n, 1, ceil(T / r))`` with ``r`` rows of ``P``
        lanes per word."""
        rng = self._transient("act_flip", self.profile.act_flip_rate,
                              layer, pass_index)
        lanes = np.asarray(lanes)
        if rng is None or lanes.size == 0 or rows <= 0:
            return xw
        k = int(lanes[rng.integers(lanes.size)])
        t = int(rng.integers(rows))
        p = int(rng.integers(xw.shape[0]))
        out = xw.clone()
        if r == 1:
            out[p, 0, t, k // 32] ^= 1 << (k % 32)
        else:
            out[p, 0, t // r] ^= 1 << ((t % r) * P + k)
        self._log("act_flip", layer, pass_index, p, t, k)
        return out

    def corrupt_values(self, vals: torch.Tensor, layer: str, pass_index: int,
                       *, filters: int, rows: int) -> torch.Tensor:
        """Whole-pass compute corruption: a nonzero additive error on one
        ``(filter, row)`` output of the pass."""
        rng = self._transient("compute", self.profile.compute_rate,
                              layer, pass_index)
        if rng is None or filters <= 0 or rows <= 0:
            return vals
        m = int(rng.integers(filters))
        t = int(rng.integers(rows))
        delta = int(rng.integers(1, 1 << 16))
        out = vals.to(torch.int64).clone()
        out[m, t] += delta
        self._log("compute", layer, pass_index, m, t, delta)
        return out

    def maybe_stall(self, layer: str, pass_index: int) -> float:
        """Injectable per-pass latency stall (sleeps ``stall_s``)."""
        rng = self._transient("stall", self.profile.stall_rate,
                              layer, pass_index)
        if rng is None:
            return 0.0
        self.stalls += 1
        self.stall_s_total += self.profile.stall_s
        self.events.append(("stall", layer, int(pass_index), 0, 0, 0))
        if self.profile.stall_s > 0:
            time.sleep(self.profile.stall_s)
        return self.profile.stall_s

    # -- bookkeeping --------------------------------------------------------
    def note_corrupt_attempt(self) -> None:
        self.corrupt_attempts += 1

    def note_detected(self) -> None:
        self.detected += 1

    def note_reexecution(self) -> None:
        self.reexecuted += 1

    def stats(self) -> dict:
        return {
            "seed": self.profile.seed,
            "injected": self.injected,
            "corrupt_attempts": self.corrupt_attempts,
            "detected": self.detected,
            "reexecuted": self.reexecuted,
            "stalls": self.stalls,
            "stall_s_total": self.stall_s_total,
            "quarantined_slices": tuple(sorted(self.quarantined)),
            "events": len(self.events),
        }


_ACTIVE: Optional[FaultState] = None


@contextlib.contextmanager
def inject(profile: FaultProfile) -> Iterator[FaultState]:
    """Scope a :class:`FaultState` over the enclosed execution.  Nests by
    shadowing (the inner scope wins) and always restores on exit."""
    global _ACTIVE
    prev = _ACTIVE
    state = FaultState(profile)
    _ACTIVE = state
    try:
        yield state
    finally:
        _ACTIVE = prev


def active() -> Optional[FaultState]:
    """The innermost active :class:`FaultState`, or None."""
    return _ACTIVE
