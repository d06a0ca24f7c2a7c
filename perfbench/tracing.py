"""What a ``--trace 1`` run records, from outside the program.

``Spans`` times module instances on the device: a forward pre-hook and a
forward hook record a CUDA event each on the current stream, so a span
is the device time from the module's first kernel to its last,
whatever implements it.  Hooks set on the float32 modules travel with
the copies the program makes of them (``copy.deepcopy`` keeps them).

``Profile`` runs ``torch.profiler`` over a steady sub-window and reduces
its trace to the device's busy seconds, the operations that took most
device time, and the longest idle gaps, each labelled with what the
host was doing then.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """CUDA-event spans of watched modules, by name: each a dict with
    ``start``/``end`` events, ``items`` (the batch), ``dtype`` and the
    module's own ``shape`` facts."""

    def __init__(self):
        self.records = defaultdict(list)
        self.active = False
        self._open = {}

    def watch(self, module, name: str, shape=None) -> None:
        def pre(mod, args):
            if self.active:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self._open[id(mod)] = (ev, args[0])

        def post(mod, args, out):
            opened = self._open.pop(id(mod), None)
            if opened is None:
                return
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            x = opened[1]
            self.records[name].append({"start": opened[0], "end": ev, "items": int(x.shape[0]),
                                       "dtype": str(x.dtype).replace("torch.", ""),
                                       "shape": shape(mod, x) if shape else None})

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)

    def watch_task(self, unet, vae) -> None:
        """The U-Net, the VAE's encoder, and every K3 and K2 module."""
        self.watch(unet, "unet")
        self.watch(vae.encoder, "vae_encoder")
        for m in unet.modules():
            kind = type(m).__name__
            if kind == "ResnetBlock":
                self.watch(m, "k3", _k3_shape)
            elif kind == "LinearAttention":
                self.watch(m, "k2", _k2_shape)

    def resolve(self) -> dict:
        """{name: [dict(ms, items, dtype, shape)]} once the device is idle."""
        torch.cuda.synchronize()
        return {name: [{"ms": r["start"].elapsed_time(r["end"]), "items": r["items"], "dtype": r["dtype"],
                        "shape": r["shape"]} for r in recs] for name, recs in self.records.items()}


def _k3_shape(mod, x):
    """(h, w, cin, co, res, emb) of a ResnetBlock on NCHW ``x``."""
    return (int(x.shape[2]), int(x.shape[3]), mod.block1.proj.in_channels, mod.block1.proj.out_channels,
            mod.res_conv is not None, mod.mlp is not None)


def _k2_shape(mod, x):
    """(dim, tokens) of a LinearAttention on NCHW ``x``."""
    return int(x.shape[1]), int(x.shape[2] * x.shape[3])


class Profile:
    """``torch.profiler`` over one sub-window: ``start`` and ``stop`` are
    called by the window's loop at step boundaries."""

    def __init__(self):
        self.prof = None
        self.window_s = None
        self._t0 = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, in set-up: its first start in a
        process initialises the device tracer, which takes seconds."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.window_s is None

    def analyse(self) -> dict:
        """busy_s, window_s and the breakdown, from the exported trace."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce_trace(events, self.window_s)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(events, window_s) -> dict:
    """Busy seconds (the union of device operations), the 10 device
    operations with the most time, and the 10 longest gaps between device
    operations, each named by the host's outermost annotation and
    innermost operation at the gap's middle."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev:
        raise RuntimeError("the profiler's trace holds no device operation")
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"][:160]] += e["dur"] * 1e-6
    host = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")),
                  key=lambda e: e["ts"])
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)),
                  reverse=True)[:10]
    idle = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        around = [h for h in host if h["ts"] <= mid <= h["ts"] + h["dur"]]
        notes = [h for h in around if h["cat"] == "user_annotation"]
        ops = [h for h in around if h["cat"] == "cpu_op"]
        label = " > ".join([min(notes, key=lambda h: h["ts"])["name"]] if notes else [])
        if ops:
            inner = max(ops, key=lambda h: h["ts"])["name"]
        else:
            before = [h for h in host if h["ts"] + h["dur"] <= mid and h["cat"] == "cpu_op"]
            inner = "python after " + (before[-1]["name"] if before else "window start")
        idle.append([f"{label} > {inner}" if label else inner, length * 1e-6])
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": window_s,
        "device_ops": [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": idle,
    }
