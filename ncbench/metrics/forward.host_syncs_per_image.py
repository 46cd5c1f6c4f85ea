"""Calls per image that made the host wait for the device (the program's
``host_syncs`` counter, over every span): reads of device values, outputs
sized by device data, and copies of host data to the device."""
from ncbench import program


def read(ctx):
    return program.counter_per_image(ctx, "host_syncs")
