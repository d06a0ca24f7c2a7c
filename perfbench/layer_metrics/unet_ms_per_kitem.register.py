"""Device ms of the registrations' bf16 U-Net sweeps per 1,000 items."""

from perfbench import readers


def read(trace):
    return readers.ms_per_items(trace, "unet", 1000.0, "bfloat16")
