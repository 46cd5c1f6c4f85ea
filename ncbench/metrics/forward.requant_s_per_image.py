"""Seconds per image in the conv epilogue's requantization
(``epilogue.requant``): the two scalar reads of the min/max tree's result,
the per-image quantization parameters and fixed-point requant, and the
per-image reads of the live output bytes."""
from ncbench import program


def read(ctx):
    return program.span_per_image(ctx, "epilogue.requant")
