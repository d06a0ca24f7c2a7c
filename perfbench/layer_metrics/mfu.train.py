"""The training window's counted model FLOPs (the U-Net's forward and
backward over the doubled batch, no recompute counted, and the frozen
VAE's 2B encodes a step) over its time at the bf16 peak."""

from perfbench import readers


def read(trace):
    return readers.mfu_pct(trace)
