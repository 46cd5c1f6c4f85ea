"""The program's LM spans and counters (``repro_torch.tracing``) over a
traced window of an LM cell.

As for the Neural Cache cells (``ncbench/program.py``), the session that
ends with the profiler holds exactly the window; here it is known by its
``lm.prefill`` spans, one for each request the window served.  A program
without those spans gives nothing to read.
"""


def session(ctx):
    """The program's last tracing session, when it holds the window of
    ``ctx`` (the harness's reader context); else None."""
    if not ctx["images"]:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    s = tracing.last_session()
    if s is None:
        return None
    prefill = s.totals().get("lm.prefill")
    if not prefill or prefill["count"] != ctx["images"]:
        return None
    return s


def span_per_request(ctx, *names):
    """Seconds per request in the spans ``names`` (their totals summed),
    or None."""
    s = session(ctx)
    if s is None:
        return None
    totals = s.totals()
    if not any(n in totals for n in names):
        return None
    return sum(totals[n]["total_s"] for n in names if n in totals) \
        / ctx["images"]


def counters(ctx):
    """Every counter summed over the session's spans, or None."""
    s = session(ctx)
    if s is None:
        return None
    out = {}
    for c in s.counters().values():
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out
