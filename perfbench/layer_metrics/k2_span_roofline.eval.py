"""K2's share of its roofline over the program's bf16 ``k2`` spans (the
LinearAttention module with its 1x1 convs, ``work.k2_work``): the twin of
``k2_roofline.eval``."""

from perfbench import program_spans, work


def read(trace):
    spans = program_spans.recorded(trace)
    return (program_spans.roofline_pct(spans, "k2", lambda shape, items: work.k2_work(shape[0], shape[1], items))
            if spans else None)
