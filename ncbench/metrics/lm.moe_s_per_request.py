"""Seconds per request in the MoE: routing (``moe.route``), the held
experts (``moe.experts``) and the shared expert (``moe.shared``), prefill
and decode."""
from ncbench import program_lm


def read(ctx):
    return program_lm.span_per_request(ctx, "moe.route", "moe.experts",
                                       "moe.shared")
