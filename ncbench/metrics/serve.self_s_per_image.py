"""Seconds per image the serving engine spends outside the forward: its
``step`` span less the ``nc_forward`` spans inside it."""


def read(ctx):
    span = ctx["spans"].get("serve")
    if not span or not ctx["images"]:
        return None
    return span["self_s"] / ctx["images"]
