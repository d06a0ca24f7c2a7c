"""Device ms of the VAE encode (the program's ``vae.encode`` spans) per
image, both dtypes: the twin of ``vae_encode_ms_per_img.eval``."""

from perfbench import program_spans


def read(trace):
    spans = program_spans.recorded(trace)
    return program_spans.ms_per_items(spans, "vae.encode", 1.0) if spans else None
