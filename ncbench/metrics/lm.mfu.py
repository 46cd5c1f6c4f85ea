"""The whole window's share of the bf16 peak, in percent: the model FLOPs
of what the window served (``ncbench/roofline_lm.py``, from the
configuration's shapes and the program's token, expert and attention
counters) over the window's length at 989 TFLOP/s."""
from ncbench import program_lm, roofline_lm


def read(ctx):
    c = program_lm.counters(ctx)
    if c is None or ctx["window_s"] <= 0:
        return None
    flops = roofline_lm.model_flops(ctx["config"], c, ctx["images"])
    return 100.0 * flops / (ctx["window_s"] * roofline_lm.BF16_FLOPS_PER_S)
