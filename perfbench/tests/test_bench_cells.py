"""Each cell driven at small sizes on the CPU: in a fresh process with no
JAX loaded, against its control and against the planted faults of its
generator (``faults/<generator module>.py``); a cell, a mix, a
configuration, a generator and a metric added as files alone, with their
tests; and, on a machine with a card, one short run of each cell."""

import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import check, harness
from perfbench.tests import toy

ROOT = harness.ROOT
CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_runs_small_in_a_fresh_process_without_jax(workload):
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); from perfbench.tests import toy; "
            "from perfbench.run import forbidden_modules; r = toy.run(sys.argv[2]); "
            "print(json.dumps({'result': r, 'forbidden': forbidden_modules()}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), workload], capture_output=True, text=True,
                         timeout=600, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["forbidden"] == []
    result = line["result"]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    e2e = {m["name"] for m in harness.reported(harness.spec(), workload, "end_to_end")}
    assert set(result["metrics"]) == e2e
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_comes_out_not_correct(workload):
    device = torch.device("cpu")
    files, run, outcome, _ = harness.drive(workload, 2**31 + 3, 1.0, False, device, time.perf_counter(),
                                           harness.spec(), toy.config(toy.config_of(workload)), toy.mix(workload))
    side = harness.side(run.cfg, "reference", 2**31 + 3, device)
    limits = harness.load_json(files["limits"])["limits"]
    assert check.verdict(outcome.check(side), limits)[0]
    assert not check.verdict(outcome.check(side, harness.side(run.cfg, "control", 2**31 + 3, device)), limits)[0]


@pytest.mark.parametrize("workload, fault", [(w, f) for w in CELLS for f in toy.faults(w)],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_planted_fault_comes_out_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert toy.run(workload, seconds=2.0)["correct"] is False


@pytest.mark.parametrize("generator", toy.generators())
def test_each_generator_plants_three_faults_or_more(generator):
    faults = toy.faults_of(generator)
    assert len(faults) >= 3 and all(callable(f) for f in faults)
    assert len({f.__name__ for f in faults}) == len(faults)


def test_a_cell_config_mix_and_metric_are_added_as_files_alone(tmp_path):
    """A throwaway configuration, mix, cell, generator, sides, faults module
    and per-layer metric come in as new files and entries appended to
    ``BENCHMARK.json``'s lists; the cell runs, and the parametrised cell,
    reference and spec tests collect it and pass, with no file changed."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "nope_tpu_torch").symlink_to(ROOT / "nope_tpu_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    bench = harness.spec()
    files = {
        "generators/toy_steps.py":
            "from perfbench.generators import eval_geodesic\n\n\ndef run(run):\n    return eval_geodesic.run(run)\n",
        "sides/toy_sides.py":
            "from perfbench.sides.pose_conditional import Control, Reference, program  # noqa: F401\n",
        "configs/toy_base.json": json.dumps(dict(
            harness.load_json(ROOT / "perfbench/configs/vae_base.json"), name="toy_base",
            source="https://example.org/toy",
            sides={name: f"perfbench.sides.toy_sides:{attr}"
                   for name, attr in (("program", "program"), ("reference", "Reference"), ("control", "Control"))})),
        "mixes/toy_eval.json": json.dumps(dict(harness.load_json(ROOT / "perfbench/mixes/eval_full.json"),
                                               protocol="fast", generator="perfbench.generators.toy_steps:run")),
        "limits/toy_base.toy_eval.json": (ROOT / "perfbench/limits/vae_base.eval_full.json").read_text(),
        "layer_metrics/toy_steps.eval.py":
            "def read(trace):\n    steps = trace['window'].get('steps')\n    return float(steps) if steps else None\n",
        "tests/toy_sizes/toy_base.json": (ROOT / "perfbench/tests/toy_sizes/vae_base.json").read_text(),
        "tests/toy_mixes/toy_steps.json": (ROOT / "perfbench/tests/toy_mixes/eval_geodesic.json").read_text(),
        "tests/faults/toy_steps.py": "from perfbench.tests.faults.eval_geodesic import FAULTS  # noqa: F401\n",
    }
    for name, text in files.items():
        assert not (tmp_path / "perfbench" / name).exists(), name
        (tmp_path / "perfbench" / name).write_text(text)
    bench["configs"].append({"name": "toy_base", "source": "https://example.org/toy", "reduced": [],
                             "file": "perfbench/configs/toy_base.json", "why": "a throwaway"})
    bench["workloads"].append({"name": "toy_base.toy_eval", "config": "toy_base", "traffic": "toy_eval",
                               "chips": 1, "why": "a throwaway"})
    bench["end_to_end"][0]["workloads"].append("toy_base.toy_eval")
    bench["per_layer"].append({"name": "toy_steps.eval", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "evaluation step (tasks/pose_conditional.py)",
                               "moves": "eval_img_per_s", "workloads": ["toy_base.toy_eval"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); from perfbench import harness; "
            "from perfbench.tests import toy; r = toy.run('toy_base.toy_eval', seed=17); "
            "m = [x['name'] for x in harness.reported(harness.spec(), 'toy_base.toy_eval', 'per_layer')]; "
            "print(json.dumps({'result': r, 'per_layer': m, "
            "'steps': harness.reader('toy_steps.eval')({'window': {'steps': 3}}), "
            "'modules': sorted(n for n in sys.modules if n.startswith('perfbench.'))}))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, timeout=600,
                         check=True, cwd=tmp_path)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["result"]["correct"] and set(line["result"]["metrics"]) == {"eval_img_per_s", "setup_s"}
    assert "toy_steps.eval" in line["per_layer"] and line["steps"] == 3.0
    assert {"perfbench.generators.toy_steps", "perfbench.sides.toy_sides"} <= set(line["modules"])

    tests = [f"perfbench/tests/{m}.py" for m in ("test_bench_cells", "test_bench_reference", "test_bench_spec")]
    out = subprocess.run([sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", "-p", "no:randomly",
                          "-k", "toy_base or toy_steps", *tests], capture_output=True, text=True, timeout=1200,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-4000:]
    outcomes = dict(m.groups() for m in re.finditer(r"^(\S+::\S+) (PASSED|SKIPPED|FAILED|ERROR)", out.stdout, re.M))
    want = ["test_bench_cells.py::test_each_cell_runs_small_in_a_fresh_process_without_jax[toy_base.toy_eval]",
            "test_bench_cells.py::test_the_control_comes_out_not_correct[toy_base.toy_eval]",
            *[f"test_bench_cells.py::test_a_planted_fault_comes_out_not_correct[toy_base.toy_eval-{f.__name__}]"
              for f in toy.faults_of("eval_geodesic")],
            "test_bench_cells.py::test_each_generator_plants_three_faults_or_more[toy_steps]",
            "test_bench_reference.py::test_the_reference_unet_and_encoder_equal_the_programs[toy_base]",
            "test_bench_spec.py::test_the_harness_finds_every_file_a_cell_names[toy_base.toy_eval]",
            "test_bench_spec.py::test_every_per_layer_metric_has_a_reader_and_its_cells_report_what_it_moves"
            "[toy_steps.eval]"]
    assert {k: outcomes.get(f"perfbench/tests/{k}") for k in want} == dict.fromkeys(want, "PASSED"), out.stdout[-4000:]
    assert outcomes.get("perfbench/tests/test_bench_cells.py::test_one_short_run_of_each_cell_on_the_card"
                        "[toy_base.toy_eval]") == ("PASSED" if torch.cuda.is_available() else "SKIPPED")
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_one_short_run_of_each_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on a machine with an NVIDIA GPU")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload, "--seed", "4294967311",
                          "--seconds", "4", "--trace", "0"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert np.isfinite(result["metrics"]["setup_s"]["value"])
