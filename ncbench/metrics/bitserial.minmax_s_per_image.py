"""Seconds per image in ``bitserial_minmax``, the §IV-D min/max log tree
over each layer's output."""


def read(ctx):
    span = ctx["spans"].get("minmax")
    if not span or not ctx["images"]:
        return None
    return span["total_s"] / ctx["images"]
