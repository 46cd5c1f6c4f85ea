"""Calls per request that made the host wait for the card (the program's
``host_syncs`` counter over every span): the prompt's copy to the card,
the per-step position vector, argmax reads, and the sorted MoE's
per-expert counts at prefill."""
from ncbench import program_lm


def read(ctx):
    c = program_lm.counters(ctx)
    return None if c is None else c["host_syncs"] / ctx["images"]
