"""Seconds per request in ``lm.prefill``: the request's prompt moved to
the card, its prefill through every layer, its caches written into its
slot, and the first token chosen (the program's span, host clock)."""
from ncbench import program_lm


def read(ctx):
    return program_lm.span_per_request(ctx, "lm.prefill")
