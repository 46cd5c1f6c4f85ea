"""Seconds per request in the attention mixers (``mixer.attn``: the
projections, kernel 4 at prefill, the cache write and the decode
attention over the cache), prefill and decode."""
from ncbench import program_lm


def read(ctx):
    return program_lm.span_per_request(ctx, "mixer.attn")
