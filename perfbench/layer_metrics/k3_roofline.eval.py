"""K3's share of its roofline: the bf16 ResnetBlocks' least time
(``work.k3_work``, ``work.bound``) over their measured spans."""

from perfbench import readers, work


def read(trace):
    return readers.roofline_pct(trace, "k3", work.k3_work)
