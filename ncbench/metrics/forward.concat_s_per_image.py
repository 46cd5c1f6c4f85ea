"""Seconds per image in the mixed blocks' concatenations (``concat``): each
branch requantized to the block's common per-image scale."""
from ncbench import program


def read(ctx):
    return program.span_per_image(ctx, "concat")
