"""Seconds per image in ``packed_dot_words``: the ``gemm`` backend's word
decode and its kernel call."""


def read(ctx):
    span = ctx["spans"].get("dot")
    if not span or not ctx["images"]:
        return None
    return span["total_s"] / ctx["images"]
