"""Profiling and timing harness (``nope_tpu/utils/profiling.py``).

The reference has no tracing story (thop FLOP hooks and wall-clock
prints only).  Here, with the JAX package's signatures and keys:

- :func:`trace`: a ``torch.profiler`` context over the host and, where a
  CUDA device is present, the device; it writes a Chrome / Perfetto trace;
- :func:`benchmark`: steady-state seconds per call, each call fenced by
  a synchronize of the CUDA devices its result lives on;
- :func:`device_memory_stats`: the caching allocator's bytes per CUDA
  device.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Callable, Dict, Set

import torch


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
