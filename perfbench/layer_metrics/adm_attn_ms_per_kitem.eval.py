"""Device ms of the ADM's attention blocks (the program's bf16 ``adm.attn``
spans) per 1,000 items of the bf16 ``unet`` spans that hold them."""

from perfbench import program_spans, work_adm


def read(trace):
    spans = program_spans.recorded(trace)
    return work_adm.ms_per_unet_kitem(spans, "adm.attn") if spans else None
