"""Kernel 4's share of its roofline, in percent: the least time of the
window's prefill attention (``attn.prefill_pairs`` causal pairs at 4 H D
operations each and the bf16 peak, or the prefills' q, k, v and output
bytes at the HBM peak, whichever is larger; ``ncbench/roofline_lm.py``)
over the device time of the bf16 flash-attention kernel in the trace."""
from ncbench import program_lm, roofline_lm

KERNEL = "::tc::kernel<"  # csrc/flash_attention.cu's tensor-core kernel


def read(ctx):
    dev_s = sum(v for k, v in ctx["kernel_s"].items() if KERNEL in k)
    c = program_lm.counters(ctx)
    if dev_s <= 0 or c is None or not c.get("attn.prefill_pairs"):
        return None
    least = roofline_lm.flash_least_s(ctx["config"], c["attn.prefill_pairs"],
                                      c["tokens.prefill"])
    return 100.0 * least / dev_s
