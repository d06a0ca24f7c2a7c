"""Small sizes of the benchmark's configurations and mixes, for the CPU.

Each is a file of its own, found by name, so a new configuration or
generator brings its small sizes without an edit here:

- ``toy_sizes/<config>.json``: overrides of the configuration's file; a
  key naming a part (``unet``, ``vae``) updates that part's ``args``, a
  key naming another group (``task``) updates the group, any other key
  (``img_size``) replaces the value;
- ``toy_mixes/<generator module>.json``: overrides of every mix that
  generator reads;
- ``faults/<generator module>.py``: the generator's planted faults
  (``FAULTS``).
"""

from __future__ import annotations

import importlib
from pathlib import Path

from perfbench import harness

HERE = Path(__file__).resolve().parent


def own_file(folder: str, name: str, suffix: str) -> Path:
    """``perfbench/tests/<folder>/<name><suffix>``, or an error naming the file to add."""
    path = HERE / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{name!r} has no small-size file: add perfbench/tests/{folder}/{name}{suffix}")
    return path


def config(name: str) -> dict:
    """The configuration at its small sizes (``toy_sizes/<name>.json``),
    which serve in float32, so that a sound run reads far inside every
    limit (set at full width) and only the control and the planted faults
    come near them."""
    entry = next(c for c in harness.spec()["configs"] if c["name"] == name)
    cfg = harness.load_json(harness.ROOT / entry["file"])
    for key, value in harness.load_json(own_file("toy_sizes", name, ".json")).items():
        target = cfg.get(key)
        if isinstance(target, dict) and "args" in target:
            target["args"].update(value)
        elif isinstance(target, dict):
            target.update(value)
        else:
            cfg[key] = value
    return cfg


def generator_module(workload: str) -> str:
    """The last name of the module of the cell's mix's generator
    (``perfbench.generators.eval_geodesic:run`` → ``eval_geodesic``)."""
    mix = harness.load_json(harness.cell_files(harness.spec(), workload)["mix"])
    return mix["generator"].split(":")[0].rsplit(".", 1)[-1]


def generators() -> list:
    """The generator modules of the cells of ``BENCHMARK.json``."""
    return sorted({generator_module(w["name"]) for w in harness.spec()["workloads"]})


def mix(workload: str) -> dict:
    m = harness.load_json(harness.cell_files(harness.spec(), workload)["mix"])
    return dict(m, **harness.load_json(own_file("toy_mixes", generator_module(workload), ".json")))


def faults_of(generator: str) -> list:
    """The planted faults of a generator module."""
    own_file("faults", generator, ".py")
    return list(importlib.import_module(f"perfbench.tests.faults.{generator}").FAULTS)


def faults(workload: str) -> list:
    return faults_of(generator_module(workload))


def run(workload: str, seed: int = 2**31 + 11, seconds: float = 1.0) -> dict:
    import time

    import torch

    return harness.run_cell(workload, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                            cfg=config(config_of(workload)), mix=mix(workload))


def config_of(workload: str) -> str:
    return harness.cell_files(harness.spec(), workload)["cell"]["config"]
