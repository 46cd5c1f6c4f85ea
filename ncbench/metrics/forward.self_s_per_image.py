"""Seconds per image in ``nc_forward`` outside the conv/FC layers and the
min/max tree: per-image requantization, concatenation, pools, quantization
parameters and the host syncs they make."""


def read(ctx):
    span = ctx["spans"].get("forward")
    if not span or not ctx["images"]:
        return None
    return span["self_s"] / ctx["images"]
