"""Kernel 1's share of its roofline, in percent: the least time of the
GEMMs the window's forwards need (each layer's M x N x K at the int8 peak,
or its bytes at the HBM peak, whichever is larger; live filters only),
over the device time of the int8 GEMM kernel in the trace."""
import importlib

from ncbench import roofline

KERNEL = "int8_gemm_kernel"


def read(ctx):
    dev_s = sum(v for k, v in ctx["kernel_s"].items() if KERNEL in k)
    if dev_s <= 0 or not ctx["batches"]:
        return None
    cfg = ctx["config"]
    ref = importlib.import_module(f"ncbench.references.{cfg['reference']}")
    least = roofline.forward_least_s(
        ref.layer_shapes(cfg), int(ctx["traffic"]["batch"]),
        float(cfg.get("prune_fraction", 0.0)))
    return 100.0 * least * ctx["batches"] / dev_s
