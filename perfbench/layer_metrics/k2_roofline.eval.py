"""K2's share of its roofline: the bf16 LinearAttention modules' least
time (``work.k2_work``, ``work.bound``) over their measured spans."""

from perfbench import readers, work


def read(trace):
    return readers.roofline_pct(trace, "k2", lambda shape, items: work.k2_work(shape[0], shape[1], items))
