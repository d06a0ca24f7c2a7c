"""The whole evaluation step's counted model FLOPs (U-Net items of the
bank and the loss, VAE encodes) over the window's time at the bf16 peak."""

from perfbench import readers


def read(trace):
    return readers.mfu_pct(trace)
