"""K3's share of its roofline over the program's bf16 ``k3`` spans
(``work.k3_work``, ``work.bound``): the twin of ``k3_roofline.eval``."""

from perfbench import program_spans, work


def read(trace):
    spans = program_spans.recorded(trace)
    return program_spans.roofline_pct(spans, "k3", work.k3_work) if spans else None
