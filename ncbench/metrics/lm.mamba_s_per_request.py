"""Seconds per request in the Mamba-2 mixers (``mixer.mamba``: in_proj,
conv, the SSD or the decode step's state update, the gated norm,
out_proj, the state's copy into the cache), prefill and decode."""
from ncbench import program_lm


def read(ctx):
    return program_lm.span_per_request(ctx, "mixer.mamba")
