#!/usr/bin/env python3
"""What a span of ``nope_tpu_torch.utils.profiling`` costs the host, off
and on.

    python3 scripts/span_cost.py [--spans 20000]

From the root of a checkout, on a CUDA GPU or, without one, the CPU (no
CUDA events then).  Times on the host clock ``--spans`` empty spans
(with a ``facts`` callable, as the ``k3`` and ``unet`` spans have) with
no profiler running, the same loop bare, then both under a
``torch.profiler`` profile of the host and the device, and a bare
``record_function`` for comparison.  Each span launches nothing, so the
device is idle and a CUDA event's record is the whole of its cost.
Prints one JSON line: microseconds a span, off and on, the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from nope_tpu_torch.utils import profiling  # noqa: E402


def per_call_us(body, n: int) -> float:
    """Host microseconds a call of ``body(n)``'s loop, best of three."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        body(n)
        best = min(best, time.perf_counter() - t0)
    return 1e6 * best / n


def spans(n: int) -> None:
    for i in range(n):
        with profiling.span("k3", request=i, facts=lambda: {"items": 1}):
            pass


def bare(n: int) -> None:
    for i in range(n):
        (lambda: {"items": 1}, i)


def annotations(n: int) -> None:
    for _ in range(n):
        with record_function("k3"):
            pass


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--spans", type=int, default=20000)
    n = parser.parse_args(argv).spans
    cuda = torch.cuda.is_available()
    if cuda:
        torch.ones(1, device="cuda").add_(1)  # the context, so spans record CUDA events
        torch.cuda.synchronize()
    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu", "card": card() if cuda else None,
           "spans": n, "bare_us": per_call_us(bare, n), "off_us": per_call_us(spans, n)}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities):
        out["on_us"] = per_call_us(spans, n)
        out["record_function_us"] = per_call_us(annotations, n)
    kept = profiling.spans(clear=True)
    out["recorded"] = len(kept)
    out["device_ms_resolved"] = sum(s["device_ms"] is not None for s in kept)
    out["off_less_bare_us"] = out["off_us"] - out["bare_us"]
    out["on_less_bare_us"] = out["on_us"] - out["bare_us"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
