"""Seconds per image in ``nc_conv2d`` (and ``nc_fc``, which calls it)
outside ``packed_dot_words``: im2col, word packing, zero-filter gather and
the affine correction."""


def read(ctx):
    span = ctx["spans"].get("layer")
    if not span or not ctx["images"]:
        return None
    return span["self_s"] / ctx["images"]
