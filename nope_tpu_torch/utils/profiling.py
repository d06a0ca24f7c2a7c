"""Profiling and timing harness (``nope_tpu/utils/profiling.py``).

The reference has no tracing story (thop FLOP hooks and wall-clock
prints only).  Here, with the JAX package's signatures and keys:

- :func:`trace`: a ``torch.profiler`` context over the host and, where a
  CUDA device is present, the device; it writes a Chrome / Perfetto trace;
- :func:`benchmark`: steady-state seconds per call, each call fenced by
  a synchronize of the CUDA devices its result lives on;
- :func:`device_memory_stats`: the caching allocator's bytes per CUDA
  device.

And the program's own instrumentation, which the JAX package has not:

- :func:`span`: a named interval at a layer boundary (the eval loop's
  phases ``eval.*``, the eval step's ``task.*``, ``vae.encode``,
  ``unet``, ``k3``, ``k2``, the serving engine's ``engine.*``).  A span
  records only while a ``torch.profiler`` profile is recording, so an
  operator's ``with profiling.trace(log_dir):`` turns them on, and they
  appear in its Chrome trace as ``user_annotation`` events on the
  device's clock.  :func:`spans` reads them after the profile: host
  times, parent, request id, attributes and, on CUDA, the device ms
  between a CUDA event recorded at entry and one at exit;
- :func:`count`: an always-on counter (the kernels' launch routes and
  recomputes, ``k3.*`` and ``k2.*``); :func:`counters` reads them::

      with profiling.trace("prof"):
          scores = evaluate_geodesic(task, loader)
      steps = [s for s in profiling.spans() if s["name"] == "eval.step"]
      profiling.counters()["k3.fused_norms"]
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler``: host (CPU) activity
    always, and CUDA kernels and copies when a CUDA device is present.  On
    exit the CUDA devices are synchronized, so the trace holds the device
    work queued inside the block, and one Chrome / Perfetto trace,
    ``<host>_<pid>.<ms>.pt.trace.json``, is written under ``log_dir``
    (opened by ``chrome://tracing``, Perfetto or TensorBoard's profiler
    plugin).  JAX's ``trace`` writes a TensorBoard ``plugins/profile``
    tree of ``xplane.pb`` files instead."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                for i in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(i)
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _cuda_devices(tree, out: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of the tensors in ``tree`` (nested tuples, lists
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def block_until_ready(tree):
    """Wait for the device work behind ``tree``: synchronize every CUDA
    device that holds one of its tensors (JAX's ``block_until_ready``
    over a pytree).  Returns ``tree``."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)
    return tree


def benchmark(
    fn: Callable, *args, iters: int = 10, warmup: int = 2, **kwargs
) -> Dict[str, float]:
    """Steady-state timing: mean/min/max seconds per call over ``iters``
    calls after ``warmup``, each on the host clock up to the end of
    :func:`block_until_ready` of its result."""
    for _ in range(warmup):
        block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {
        "mean_s": sum(times) / len(times),
        "min_s": min(times),
        "max_s": max(times),
        "iters": float(iters),
    }


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per CUDA device (keyed ``"cuda:<i>"``): ``bytes_in_use`` and
    ``peak_bytes_in_use``, the caching allocator's
    ``allocated_bytes.all.current`` and ``.peak`` (what
    ``torch.cuda.memory_allocated`` and ``max_memory_allocated`` read).
    ``{}`` when no CUDA device is present."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        stats[str(torch.device("cuda", i))] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
        }
    return stats


# -- spans and counters -----------------------------------------------------------------------

#: the most spans the store keeps; later ones are dropped and counted as
#: ``profiling.dropped_spans``
MAX_SPANS = 200_000

_COUNTERS: Dict[str, int] = {}
_SPANS: List["_Span"] = []
_IDS = itertools.count()
_LOCAL = threading.local()
#: what :func:`span` returns while spans are off
_OFF = contextlib.nullcontext()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter, by name."""
    return dict(_COUNTERS)


def batch_facts(x: torch.Tensor) -> Dict[str, Any]:
    """A span's attributes of a batch: ``items`` (its leading size) and
    ``dtype`` (``"bfloat16"``, ``"float32"``)."""
    return {"items": int(x.shape[0]), "dtype": str(x.dtype).replace("torch.", "")}


class _Span:
    """One recorded span: a ``record_function`` of its name, host
    ``perf_counter_ns`` at entry and exit, its parent and request, and on
    CUDA a timing event at entry and one at exit, both on the stream
    current at entry."""

    __slots__ = ("name", "id", "parent", "request", "attrs", "t0", "t1", "events", "device_ms", "_rf", "_stream")

    def __init__(self, name: str, request, attrs: Dict[str, Any]):
        self.name, self.request, self.attrs = name, request, attrs
        self.events = self.device_ms = self._stream = None

    def __enter__(self):
        stack = _open_spans()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent else None
        if self.request is None and parent is not None:
            self.request = parent.request
        self.id = next(_IDS)
        self._rf = _autograd_profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_initialized():
            # one stream lookup a span: a lookup costs about as much as a record
            self._stream = torch.cuda.current_stream()
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(self._stream)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self.events:
            self.events[1].record(self._stream)
        self._rf.__exit__(None, None, None)
        self._rf = self._stream = None
        stack = _open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        if len(_SPANS) < MAX_SPANS:
            _SPANS.append(self)
        else:
            count("profiling.dropped_spans")


def _open_spans() -> list:
    """This thread's recorded spans not yet exited, outermost first."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def span(name: str, request=None, facts: Optional[Callable[[], Dict[str, Any]]] = None, **attrs):
    """A context manager that records the block as a span named ``name``,
    while a ``torch.profiler`` profile is recording; otherwise it records
    nothing, and costs one read of the profiler's flag.  A span whose
    entry found the profiler off records nothing, even if it starts within.

    ``request`` (a batch or call index) defaults to the enclosing span's.
    ``attrs`` are plain ints, strings or tuples; ``facts``, where given,
    is called at entry while recording and its dict joins them, so an
    attribute that costs work to compute costs it only then.  No span
    synchronizes the device or reads a device value: its CUDA events are
    resolved by :func:`spans`."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if facts is not None:
        attrs.update(facts())
    return _Span(name, request, attrs)


def spans(clear: bool = False) -> List[Dict[str, Any]]:
    """The recorded spans in the order they were entered, each a dict:
    ``name``, ``id``, ``parent`` (the enclosing recorded span's id, or
    None), ``request``, ``attrs``, ``t0_ns`` and ``t1_ns`` (host
    ``perf_counter_ns`` at entry and exit), ``host_ms``, and ``device_ms``
    (from the entry event to the exit event; None without CUDA).  Reading
    waits for the exit events of spans not yet resolved.  ``clear`` empties
    the store."""
    done = sorted(_SPANS, key=lambda s: s.id)
    for s in done:
        if s.events:
            s.events[1].synchronize()
            s.device_ms, s.events = s.events[0].elapsed_time(s.events[1]), None
    if clear:
        _SPANS.clear()
    return [{"name": s.name, "id": s.id, "parent": s.parent, "request": s.request, "attrs": dict(s.attrs),
             "t0_ns": s.t0, "t1_ns": s.t1, "host_ms": (s.t1 - s.t0) * 1e-6, "device_ms": s.device_ms}
            for s in done]
