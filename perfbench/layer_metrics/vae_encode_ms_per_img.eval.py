"""Device ms of the VAE encoder per image, over all its calls (both dtypes)."""

from perfbench import readers


def read(trace):
    return readers.ms_per_items(trace, "vae_encoder", 1.0)
