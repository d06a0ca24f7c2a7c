"""Device ms of the ADM's res blocks (the program's bf16 ``adm.res`` spans)
per 1,000 items of the bf16 ``unet`` spans that hold them."""

from perfbench import program_spans, work_adm


def read(trace):
    spans = program_spans.recorded(trace)
    return work_adm.ms_per_unet_kitem(spans, "adm.res") if spans else None
