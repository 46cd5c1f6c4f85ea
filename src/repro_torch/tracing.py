"""Spans and counters inside the program, kept in memory.

A span is ``(name, start_ns, end_ns, depth, children_ns)`` on the host
clock ``time.perf_counter_ns()``; spans nest, and a span's self time is its
length less the spans directly inside it.  :meth:`Session.segments` cuts
the spans' time where the innermost open span changes, into sorted
``(start_ns, end_ns, name)``, so that each span can be laid against the
device's idle gaps on the same clock.  A span never synchronizes the
device: it holds the host's time in it, and the device work it launched may
finish later.

Counters go to the innermost open span.  Every span's counters hold
``host_syncs``, the calls on the served path that make the host wait for
the device (reads of device values into Python, operations whose output
size depends on device data, copies of host data into device tensors),
and ``host_wait_ns``, the time the host spent in them; every such call
goes through :func:`fetch`.  :func:`count` adds to any other counter
(tokens, expert assignments, attention pairs), by a Python number or by a
device tensor, which is read only when the session's counters are: the
count makes the host wait for nothing.

Tracing is on while a ``torch.profiler`` session records in this process,
and inside :func:`session`.  While it is on, each span also opens a
``torch.profiler.record_function`` range of its name, so that a profiler's
exported trace shows the spans beside the kernels.  While it is off,
opening a span is one flag check: no clock read, no allocation, no
``record_function``; :func:`fetch` only makes its call.

A session holds what was recorded between one switch-on and the next
switch-off: it ends when :func:`session` exits, or, for a profiler's, at
the first span or :func:`last_session` call after the profiler stopped.
:func:`last_session` returns the newest.

    with tracing.session():
        engine.step()
    s = tracing.last_session()
    s.totals()["forward"]["self_s"], s.counters()["epilogue.requant"]
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["Session", "span", "fetch", "count", "annotate", "enabled",
           "session", "last_session"]

_profiling = torch._C._autograd._profiler_enabled

_forced = 0  # open session() contexts
_current: "Session | None" = None
_last: "Session | None" = None


class Session:
    """What one switch-on recorded: closed spans in ``records`` (in closing
    order), each one's ``(ident, root ident)`` in ``idents`` (the root is
    the outermost span open around it, so that the spans of one served
    batch share its number), annotations by record index in ``attrs``, and
    the counters by span name."""

    def __init__(self):
        self.records = []  # (name, start_ns, end_ns, depth, children_ns)
        self.idents = []  # (ident, root ident)
        self.attrs = {}  # record index -> {key: value}
        self._counters = {}  # span name -> {counter: total}
        self._pending = []  # (span name, counter, 0-d device tensor)
        self._stack = []  # open _Span objects

    def _slot(self) -> tuple[str, dict]:
        """The innermost open span's name and counters."""
        name = self._stack[-1].name if self._stack else ""
        return name, self._counters.setdefault(name, {"host_syncs": 0,
                                                      "host_wait_ns": 0})

    def _count(self, wait_ns: int) -> None:
        _, c = self._slot()
        c["host_syncs"] += 1
        c["host_wait_ns"] += wait_ns

    def _add(self, counter: str, n) -> None:
        name, c = self._slot()
        c.setdefault(counter, 0)
        if torch.is_tensor(n):
            self._pending.append((name, counter, n))
        else:
            c[counter] += int(n)

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

    def counters(self) -> dict:
        """``{span name: {"host_syncs", "host_wait_ns", ...}}`` (the other
        counters where :func:`count` added to them); ``""`` holds what was
        counted outside every span.  Counts made by device tensors are read
        here, one read for each span's counter."""
        if self._pending:
            groups = {}
            for name, counter, t in self._pending:
                groups.setdefault((name, counter), []).append(
                    t.reshape(()).to(torch.int64))
            self._pending = []
            for (name, counter), ts in groups.items():
                self._counters[name][counter] += int(torch.stack(ts).sum())
        return {k: dict(v) for k, v in self._counters.items()}

    def segments(self):
        """The spans' time cut where the innermost open span changes:
        sorted ``(start_ns, end_ns, name)``."""
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


class _Span:
    __slots__ = ("name", "ident", "session", "start", "children", "attrs",
                 "range")

    def __init__(self, name: str, ident):
        self.name, self.ident = name, ident

    def __enter__(self):
        s = _current_session()
        self.session, self.children, self.attrs = s, 0, None
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        s._stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        s = self.session
        stack = s._stack
        stack.pop()
        dur = end - self.start
        if stack:
            stack[-1].children += dur
        root = stack[0].ident if stack else self.ident
        if self.attrs:
            s.attrs[len(s.records)] = self.attrs
        s.records.append((self.name, self.start, end, len(stack),
                          self.children))
        s.idents.append((self.ident, root))
        self.range.__exit__(*exc)
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _end() -> None:
    """Close the current session; it becomes the last."""
    global _current, _last
    if _current is not None:
        _last, _current = _current, None


def enabled() -> bool:
    """Whether spans and counters are recorded now."""
    return bool(_forced or _profiling())


def span(name: str, ident=None):
    """A context manager timing its body as span ``name``; ``ident`` names
    what it works on (a layer, a batch's number)."""
    if _forced or _profiling():
        return _Span(name, ident)
    if _current is not None:
        _end()
    return _OFF


def annotate(key: str, value) -> None:
    """Attach ``key: value`` to the innermost open span (while on)."""
    if not (_forced or _profiling()) or _current is None \
            or not _current._stack:
        return
    top = _current._stack[-1]
    if top.attrs is None:
        top.attrs = {}
    top.attrs[key] = value


def fetch(call, *args, **kwargs):
    """``call(*args, **kwargs)``, a call that makes the host wait for the
    device; while tracing is on, counted as one host sync of the innermost
    open span and its wait timed."""
    if not (_forced or _profiling()):
        return call(*args, **kwargs)
    s = _current_session()
    t0 = time.perf_counter_ns()
    out = call(*args, **kwargs)
    s._count(time.perf_counter_ns() - t0)
    return out


def count(counter: str, n) -> None:
    """Add ``n`` (a Python number, or a 0-d integer device tensor read
    when the session's counters are) to ``counter`` of the innermost open
    span, while tracing is on."""
    if _forced or _profiling():
        _current_session()._add(counter, n)


def _current_session() -> Session:
    global _current
    if _current is None:
        _current = Session()
    return _current


@contextlib.contextmanager
def session():
    """Tracing on while the context is open, into a new session (yielded;
    nested contexts share the outer one's)."""
    global _forced
    if not _forced:
        _end()
        _current_session()
    _forced += 1
    s = _current
    try:
        yield s
    finally:
        _forced -= 1
        if not _forced:
            _end()


def last_session() -> Session | None:
    """The newest session that has ended, or the one still recording."""
    if _current is not None and not (_forced or _profiling()):
        _end()
    return _current if _current is not None else _last
