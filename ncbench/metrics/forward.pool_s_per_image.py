"""Seconds per image in the max and average pools (``pool``), the final
global average pool included."""
from ncbench import program


def read(ctx):
    return program.span_per_image(ctx, "pool")
