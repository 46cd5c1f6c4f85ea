"""The whole step's share of the int8 peak, in percent: two operations per
multiply-accumulate of every conv and FC layer (live filters only) for
every image of the traced window, over the window's length at 1,979 TOP/s."""
import importlib

from ncbench import roofline


def read(ctx):
    if ctx["busy_s"] <= 0 or not ctx["images"]:
        return None
    cfg = ctx["config"]
    ref = importlib.import_module(f"ncbench.references.{cfg['reference']}")
    macs = roofline.macs_per_image(ref.layer_shapes(cfg),
                                   float(cfg.get("prune_fraction", 0.0)))
    return (100.0 * 2.0 * macs * ctx["images"]
            / (ctx["window_s"] * roofline.INT8_OPS_PER_S))
