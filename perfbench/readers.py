"""Reductions the per-layer metric files share.  Each takes the traced
run's record: ``spans`` ({name: [dict(ms, items, dtype, shape)]}),
``profile`` (busy_s, window_s) and ``window`` (seconds, model_flops).
A reduction that finds nothing to read returns None."""

from __future__ import annotations

from perfbench import work


def _calls(trace: dict, span: str, dtype=None) -> list:
    return [c for c in trace["spans"].get(span, []) if dtype is None or c["dtype"] == dtype]


def idle_pct(trace: dict):
    """The share of the profiled sub-window in which no device operation ran."""
    prof = trace.get("profile")
    if not prof or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def ms_per_items(trace: dict, span: str, per: float, dtype=None):
    """Device ms of a module's spans per ``per`` items it took."""
    calls = _calls(trace, span, dtype)
    items = sum(c["items"] for c in calls)
    return per * sum(c["ms"] for c in calls) / items if items else None


def roofline_pct(trace: dict, span: str, work_of, dtype: str = "bfloat16"):
    """The module's least time (``work.bound`` of ``work_of(shape, items)``)
    over its measured spans, as a share."""
    calls = _calls(trace, span, dtype)
    if not calls:
        return None
    least = sum(work.bound(*work_of(c["shape"], c["items"]))[0] for c in calls)
    return 100.0 * least / sum(c["ms"] for c in calls)


def mfu_pct(trace: dict):
    """Counted model FLOPs of the window over its time at the bf16 peak."""
    win = trace.get("window") or {}
    if not win.get("model_flops"):
        return None
    return 100.0 * win["model_flops"] / win["seconds"] / work.BF16_TC_OPS
