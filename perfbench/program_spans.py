"""Reductions of the program's own spans, which
``nope_tpu_torch.utils.profiling`` records while a ``torch.profiler``
profile runs: in a ``--trace 1`` run, the profiled sub-window.

Each per-layer metric file that reads them calls :func:`recorded` on the
traced run's record and reduces the list it gets with one function here.
A reduction that finds nothing to read returns None, and so does
:func:`recorded` where no sub-window was profiled or the program keeps no
spans (a version from before them).  Each span is a dict: ``name``,
``id``, ``parent``, ``request``, ``attrs``, ``t0_ns``, ``t1_ns``,
``host_ms``, ``device_ms``.
"""

from __future__ import annotations

from perfbench import work


def recorded(trace: dict):
    """The program's spans of the profiled sub-window, or None."""
    if not trace.get("profile"):
        return None
    try:
        from nope_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return (read() or None) if read else None


def named(spans: list, name: str, dtype=None, under=None) -> list:
    """The spans called ``name`` (of ``dtype`` where given, inside a span
    called ``under`` where given)."""
    by_id = {s["id"]: s for s in spans}

    def inside(s):
        parent = by_id.get(s["parent"])
        while parent is not None:
            if parent["name"] == under:
                return True
            parent = by_id.get(parent["parent"])
        return False

    return [s for s in spans if s["name"] == name and (dtype is None or s["attrs"].get("dtype") == dtype)
            and (under is None or inside(s))]


def mean_device_ms(spans: list, name: str):
    """The mean device ms of the spans called ``name``."""
    calls = [s["device_ms"] for s in named(spans, name) if s["device_ms"] is not None]
    return sum(calls) / len(calls) if calls else None


def ms_per_items(spans: list, name: str, per: float, dtype=None, under=None):
    """Device ms of the spans called ``name`` per ``per`` of their items."""
    calls = [s for s in named(spans, name, dtype, under) if s["device_ms"] is not None]
    items = sum(s["attrs"]["items"] for s in calls)
    return per * sum(s["device_ms"] for s in calls) / items if items else None


def roofline_pct(spans: list, name: str, work_of, dtype: str = "bfloat16"):
    """The modules' least time (``work.bound`` of ``work_of(shape,
    items)``) over their spans' device time, as a share."""
    calls = [s for s in named(spans, name, dtype) if s["device_ms"] is not None]
    if not calls:
        return None
    least = sum(work.bound(*work_of(s["attrs"]["shape"], s["attrs"]["items"]))[0] for s in calls)
    return 100.0 * least / sum(s["device_ms"] for s in calls)


def between_steps_ms(spans: list):
    """The mean host ms from the end of batch i's ``eval.wait`` (the step's
    device work done) to the start of batch i+1's ``eval.step``: the time
    in which the device has nothing queued."""
    steps = {s["request"]: s for s in named(spans, "eval.step")}
    gaps = [(steps[w["request"] + 1]["t0_ns"] - w["t1_ns"]) * 1e-6 for w in named(spans, "eval.wait")
            if w["request"] + 1 in steps]
    return sum(gaps) / len(gaps) if gaps else None


def _children(spans: list, parent: dict, name: str) -> list:
    return [s for s in spans if s["parent"] == parent["id"] and s["name"] == name]


def estimate_host_ms(spans: list):
    """The mean host ms of ``engine.estimate`` less its ``engine.wait``
    child: the host's own work in a call."""
    calls = [s["host_ms"] - sum(w["host_ms"] for w in _children(spans, s, "engine.wait"))
             for s in named(spans, "engine.estimate")]
    return sum(calls) / len(calls) if calls else None


def service_ms(spans: list):
    """The mean service time of the engine's calls: an estimate's host ms
    (it ends on the host, with the answer); a registration's larger of its
    host ms and its device ms (its bank is done on the device)."""
    times = [s["host_ms"] for s in named(spans, "engine.estimate")]
    times += [max(s["host_ms"], s["device_ms"] or 0.0) for s in named(spans, "engine.register")]
    return sum(times) / len(times) if times else None
