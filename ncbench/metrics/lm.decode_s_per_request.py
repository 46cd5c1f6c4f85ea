"""Seconds per request in ``lm.decode``, the engine's ``decode_step``
calls: every layer for the batch's next tokens (the program's span, host
clock; a request's share of the batch's decode steps)."""
from ncbench import program_lm


def read(ctx):
    return program_lm.span_per_request(ctx, "lm.decode")
