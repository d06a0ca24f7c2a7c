"""Device ms of the bf16 U-Net forwards (the program's ``unet`` spans) per
1,000 items: the twin of ``unet_ms_per_kitem.eval``."""

from perfbench import program_spans


def read(trace):
    spans = program_spans.recorded(trace)
    return program_spans.ms_per_items(spans, "unet", 1000.0, "bfloat16") if spans else None
