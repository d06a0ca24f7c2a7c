"""The ADM's res blocks' share of their roofline over the program's bf16
``adm.res`` spans (``work_adm.res_work``, ``work.bound``)."""

from perfbench import program_spans, work_adm


def read(trace):
    spans = program_spans.recorded(trace)
    return program_spans.roofline_pct(spans, "adm.res", work_adm.res_work) if spans else None
