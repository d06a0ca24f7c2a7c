"""Device ms of the bf16 U-Net sweep (the bank) per 1,000 items."""

from perfbench import readers


def read(trace):
    return readers.ms_per_items(trace, "unet", 1000.0, "bfloat16")
