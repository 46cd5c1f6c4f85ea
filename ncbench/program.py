"""The program's own spans and counters (``repro_torch.tracing``) over a
traced window.

A traced run records its window under ``torch.profiler``, which switches
the program's tracing on; the session that ends with the profiler holds
exactly the window's batches.  A program without the tracing module, or a
session whose ``serve.step`` count is not the window's batch count, gives
nothing to read.
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
    step = s.totals().get("serve.step")
    if not step or step["count"] != ctx["batches"]:
        return None
    return s


def span_per_image(ctx, name: str, key: str = "total_s"):
    """Seconds per image in span ``name`` (``key``: ``total_s`` or
    ``self_s``), or None."""
    s = session(ctx)
    span = s.totals().get(name) if s is not None else None
    if not span:
        return None
    return span[key] / ctx["images"]


def counter_per_image(ctx, counter: str):
    """Counter ``counter`` summed over every span, per image, or None."""
    s = session(ctx)
    if s is None:
        return None
    return sum(c[counter] for c in s.counters().values()) / ctx["images"]
