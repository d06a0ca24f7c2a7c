"""One run of one cell: find the cell's configuration, traffic mix,
limits and per-layer metrics by name, drive the window, judge a sample
of its answers against the reference, and assemble the result line.

Everything that belongs to one configuration, mix, cell or metric is a
file of its own under ``perfbench/``: ``configs/<config>.json``,
``mixes/<traffic>.json``, ``limits/<workload>.json`` and
``layer_metrics/<metric>.py`` (a ``read(trace)`` that returns a number,
or None where it finds nothing to read).  Code is found by name too: a
mix's ``generator`` and a configuration's ``sides`` (``program``,
``reference``, ``control``) are ``"module:name"`` paths, so a new kind of
traffic or of task is a new file, never an edit of one that is here.
The benchmark's tests take theirs the same way: a configuration's small
sizes in ``tests/toy_sizes/<config>.json``, a generator's small mix in
``tests/toy_mixes/<generator module>.json`` and its planted faults in
``tests/faults/<generator module>.py``.  A new configuration or cell is
new files plus entries appended to ``BENCHMARK.json``'s lists.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Callable

import torch

from perfbench import check, inputs, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Outcome:
    """What a generator returns: the end-to-end metrics, the counts, what
    the per-layer readers read, and the judge of the window's answers."""

    metrics: dict
    attempted: int
    failed: int
    window: dict
    #: check(side, stand_in=None) → readings: the sample of answers judged
    #: against ``side``; with ``stand_in`` its answers replace the program's
    check: Callable


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(bench: dict, workload: str) -> dict:
    """The cell's entry and the files it names."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {"cell": cell, "config": ROOT / config["file"], "mix": HERE / "mixes" / f"{cell['traffic']}.json",
            "limits": HERE / "limits" / f"{workload}.json"}


def reported(bench: dict, workload: str, table: str) -> list:
    """The metrics of ``table`` this cell reports: an end-to-end metric
    unless its ``workloads`` leave the cell out, a per-layer metric where
    its ``workloads`` name the cell."""
    return [m for m in bench[table]
            if workload in (m.get("workloads", [workload]) if table == "end_to_end" else m["workloads"])]


def side(cfg: dict, name: str, seed: int, device: torch.device):
    """The configuration's ``reference`` or ``control`` side, built from the seed."""
    return inputs.resolve(cfg["sides"][name])(cfg, seed, device)


def reader(name: str):
    """The ``read`` of ``layer_metrics/<name>.py``."""
    path = HERE / "layer_metrics" / f"{name}.py"
    loaded = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(module)
    return module.read


class Run:
    """The state one run's generator works against: the configuration, the
    mix, the seed, the program's constructor, the window's clock and, in a
    traced run, the spans and the profiler."""

    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device: torch.device,
                 t_start: float):
        self.cfg, self.mix, self.seed, self.seconds, self.device = cfg, mix, seed, seconds, device
        self.t_start = t_start
        self.cuda = device.type == "cuda"
        self.spans = tracing.Spans() if trace else None
        self.profile = tracing.Profile() if trace else None
        self.setup_s = self.memory_peak = None
        self._prof_t0 = None

    def program(self):
        """The program's system under test, built by the configuration's
        ``sides.program`` from this run."""
        return inputs.resolve(self.cfg["sides"]["program"])(self)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def open_window(self) -> float:
        if self.profile:
            self.profile.warm()
        self.sync()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        if self.spans:
            self.spans.active = True
        return t0

    def profile_at(self, now: float, first_step_done: bool) -> None:
        """Called by the generator between steps: starts the profiler once the
        first step is done, stops it ``trace_seconds`` later."""
        if not self.profile:
            return
        if self.profile.prof is None and first_step_done:
            self.profile.start()
            self._prof_t0 = time.perf_counter()
        elif self.profile.running and now >= self._prof_t0 + self.mix["trace_seconds"]:
            self.profile.stop()

    def close_window(self) -> None:
        self.sync()
        if self.spans:
            self.spans.active = False
        if self.profile and self.profile.running:
            self.profile.stop()
        if self.cuda:
            self.memory_peak = torch.cuda.max_memory_allocated()


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def drive(workload: str, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
          bench: dict, cfg: dict = None, mix: dict = None):
    """Set-up and window of one run: (files, run, outcome, trace record),
    with the program's state freed.  ``cfg`` and ``mix`` replace the
    cell's files (the CPU tests' small sizes)."""
    files = cell_files(bench, workload)
    cfg, mix = cfg or load_json(files["config"]), mix or load_json(files["mix"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(cfg, mix, seed, seconds, trace, device, t_start)
    outcome = inputs.resolve(mix["generator"])(run)
    record = {"window": outcome.window, "spans": run.spans.resolve() if run.spans else {},
              "profile": run.profile.analyse() if run.profile and run.profile.prof else None}
    free()
    return files, run, outcome, record


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
             bench: dict = None, cfg: dict = None, mix: dict = None) -> dict:
    """One run: the result line's keys and the checks beside their limits."""
    bench = bench or spec()
    files, run, outcome, record = drive(workload, seed, seconds, trace, device, t_start, bench, cfg, mix)
    readings = outcome.check(side(run.cfg, "reference", seed, device))
    free()
    limits = load_json(files["limits"])["limits"]
    correct, rows = check.verdict(readings, limits)
    metrics = {}
    if trace:
        for m in reported(bench, workload, "per_layer"):
            value = reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(outcome.metrics, setup_s=run.setup_s)
        for m in reported(bench, workload, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": files["cell"]["chips"], "memory_peak_bytes": run.memory_peak or 0}
    result = {"correct": bool(correct and outcome.failed == 0), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device_info}
    if record["profile"]:
        device_info.update(busy_s=record["profile"]["busy_s"], window_s=record["profile"]["window_s"])
        result["breakdown"] = {k: record["profile"][k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    result["checks"]["failed_calls"] = {"value": outcome.failed, "limit": 0}
    return result
