"""The device's idle share over the profiled sub-window of the training
window (torch.profiler)."""

from perfbench import readers


def read(trace):
    return readers.idle_pct(trace)
