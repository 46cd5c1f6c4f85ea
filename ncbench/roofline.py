"""The yardstick's peaks and work counts.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity, at the 700 W limit).  The work of a cell is counted from the
configuration's own layer table (``references``), never from the program:
the GEMMs the layers need, with the live filters only, whatever kernel
computes them.
"""
from __future__ import annotations

INT8_OPS_PER_S = 1.979e15
HBM_BYTES_PER_S = 3.35e12


def live_filters(m: int, name: str, prune_fraction: float) -> int:
    """Filters of a layer left live by the last-k pruning rule (the FC is
    never pruned)."""
    if name == "FullyConnected" or not prune_fraction:
        return m
    return m - int(round(m * prune_fraction))


def gemms(layers, batch: int, prune_fraction: float = 0.0):
    """``(M, N, K)`` of each layer's GEMM for one forward of ``batch``
    images: M = output pixels of the batch, N = live filters, K = R*S*C."""
    return [(batch * e * f, live_filters(m, name, prune_fraction), r * s * c)
            for name, r, s, c, m, e, f in layers]


def gemm_least_s(m: int, n: int, k: int) -> float:
    """Least time of one int8 GEMM: the larger of its operations at the
    int8 peak and its bytes (uint8 operands read once, the int32 result
    written once) at the HBM peak."""
    ops = 2.0 * m * n * k
    nbytes = m * k + k * n + 4 * m * n
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def forward_least_s(layers, batch: int, prune_fraction: float = 0.0) -> float:
    return sum(gemm_least_s(*g) for g in gemms(layers, batch, prune_fraction))


def macs_per_image(layers, prune_fraction: float = 0.0) -> int:
    """Multiply-accumulates of one image through every conv and FC layer,
    live filters only."""
    return sum(e * f * r * s * c * live_filters(m, name, prune_fraction)
               for name, r, s, c, m, e, f in layers)
