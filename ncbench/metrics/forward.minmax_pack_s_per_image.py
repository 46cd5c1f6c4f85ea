"""Seconds per image in ``nc_minmax`` outside the min/max log tree: the
bias, the pad to a power of two, and the packing and unpacking of bit
planes around the tree (the ``minmax`` span's self time)."""
from ncbench import program


def read(ctx):
    return program.span_per_image(ctx, "minmax", "self_s")
