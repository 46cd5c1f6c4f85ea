"""Synchronizing spans around the calls into the program's layers.

Each wrapped call synchronizes the device before and after itself, so that
its span holds the device work it launched, and records ``(name, start,
end)`` on the host clock (``perf_counter_ns``).  Spans nest; a span's self
time is its length less the spans directly inside it.  Wrappers are
installed by replacing a module attribute and removed on exit, so a call
that goes through the module (``bs.packed_dot_words(...)``) is caught
wherever it is made.
"""
from __future__ import annotations

import contextlib
import importlib
import time

import torch


class SpanRecorder:
    def __init__(self, device: torch.device):
        self.device = device
        self.records = []  # (name, start_ns, end_ns, depth, children_ns)
        self._stack = []  # [name, start_ns, children_ns]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        self._sync()
        frame = [name, time.perf_counter_ns(), 0]
        self._stack.append(frame)
        try:
            yield
        finally:
            self._sync()
            end = time.perf_counter_ns()
            self._stack.pop()
            dur = end - frame[1]
            if self._stack:
                self._stack[-1][2] += dur
            self.records.append((name, frame[1], end, len(self._stack),
                                 frame[2]))

    def wrap(self, name: str, fn):
        def wrapper(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapper

    @contextlib.contextmanager
    def patched(self, targets):
        """Wrap ``module.attr`` for each ``(name, "module:attr")`` of
        ``targets`` while the context is open."""
        saved = []
        try:
            for name, target in targets:
                mod_name, attr = target.split(":")
                mod = importlib.import_module(mod_name)
                saved.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, self.wrap(name, getattr(mod, attr)))
            yield self
        finally:
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)

    def totals(self) -> dict:
        """``{name: {"total_s", "self_s", "count"}}``."""
        out = {}
        for name, start, end, _, children in self.records:
            t = out.setdefault(name, {"total_s": 0.0, "self_s": 0.0,
                                      "count": 0})
            t["total_s"] += (end - start) / 1e9
            t["self_s"] += (end - start - children) / 1e9
            t["count"] += 1
        return out

    def segments(self):
        """The window cut where the innermost open span changes: sorted
        ``(start_ns, end_ns, name)`` over the time the spans cover."""
        marks = []  # closings before openings at one instant, inner first
        for name, start, end, depth, _ in self.records:
            marks.append((start, 1, depth, name))
            marks.append((end, 0, -depth, name))
        marks.sort()
        out, stack, last = [], [], None
        for t, opening, _, name in marks:
            if stack and t > last:
                out.append((last, t, stack[-1]))
            if opening:
                stack.append(name)
            else:
                stack.pop()
            last = t
        return out
