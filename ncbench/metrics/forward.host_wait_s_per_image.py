"""Seconds per image the host spent blocked in those calls (the program's
``host_wait_ns`` counter, over every span)."""
from ncbench import program


def read(ctx):
    v = program.counter_per_image(ctx, "host_wait_ns")
    return None if v is None else v / 1e9
