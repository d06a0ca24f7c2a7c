"""Each cell driven at small sizes on the CPU: in a fresh process with no
JAX loaded, against its control and against planted faults; a cell, a
mix, a configuration and a metric added as files alone; and, on a
machine with a card, one short run of each cell."""

import json
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


def _eval_answer_altered(monkeypatch):
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask

    step = PoseConditionalTask.eval_geodesic_step

    def altered(self, batch, **kwargs):
        out = step(self, batch, **kwargs)
        out["similarity"] = out["similarity"].roll(1, dims=1)
        return out

    monkeypatch.setattr(PoseConditionalTask, "eval_geodesic_step", altered)


def _eval_half_batch(monkeypatch):
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask

    loss = PoseConditionalTask.forward_loss
    monkeypatch.setattr(PoseConditionalTask, "forward_loss",
                        lambda self, q, r, rel: loss(self, q[:len(q) // 2], r[:len(r) // 2], rel[:len(rel) // 2]))


def _eval_topk_altered(monkeypatch):
    from nope_tpu_torch.ops import similarity
    from nope_tpu_torch.tasks import pose_conditional

    top_k = similarity.top_k
    for module in (similarity, pose_conditional):
        monkeypatch.setattr(module, "top_k", lambda sim, k: top_k(sim, k).flip(-1))


def _serve_answer_altered(monkeypatch):
    from nope_tpu_torch.serving.engine import PoseEstimator

    assemble = PoseEstimator._assemble
    monkeypatch.setattr(PoseEstimator, "_assemble",
                        lambda self, sim, idx, *a, **k: assemble(self, sim.roll(1, dims=1), idx, *a, **k))


def _serve_nearest_altered(monkeypatch):
    from nope_tpu_torch.serving.engine import PoseEstimator

    assemble = PoseEstimator._assemble
    monkeypatch.setattr(PoseEstimator, "_assemble",
                        lambda self, sim, idx, *a, **k: assemble(self, sim, idx.flip(1), *a, **k))


def _serve_state_unchanged(monkeypatch):
    from nope_tpu_torch.serving.engine import PoseEstimator

    register = PoseEstimator.register_objects

    def unchanged(self, ids, *args, **kwargs):
        if set(ids) <= {"o0", "o1", "o2", "o3"}:  # the set-up's gallery; later registrations change nothing
            register(self, ids, *args, **kwargs)

    monkeypatch.setattr(PoseEstimator, "register_objects", unchanged)


FAULTS = {
    "vae_base.eval_full": [_eval_answer_altered, _eval_topk_altered, _eval_half_batch],
    "vae_cin_ldm.eval_fast": [_eval_answer_altered, _eval_topk_altered, _eval_half_batch],
    "vae_base.serve_mixed": [_serve_answer_altered, _serve_nearest_altered, _serve_state_unchanged],
}


@pytest.mark.parametrize("workload, fault", [(w, f) for w in CELLS for f in FAULTS[w]],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_planted_fault_comes_out_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert toy.run(workload, seconds=2.0)["correct"] is False


def test_a_cell_config_mix_and_metric_are_added_as_files_alone(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "nope_tpu_torch").symlink_to(ROOT / "nope_tpu_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    bench = harness.spec()
    (tmp_path / "perfbench/generators/toy_steps.py").write_text(
        "from perfbench.generators import eval_geodesic\n\n\ndef run(run):\n    return eval_geodesic.run(run)\n")
    (tmp_path / "perfbench/sides/toy_sides.py").write_text(
        "from perfbench.sides.pose_conditional import Control, Reference, program  # noqa: F401\n")
    sides = {name: f"perfbench.sides.toy_sides:{attr}"
             for name, attr in (("program", "program"), ("reference", "Reference"), ("control", "Control"))}
    cfg = dict(toy.config("vae_base"), name="toy_base", sides=sides)
    (tmp_path / "perfbench/configs/toy_base.json").write_text(json.dumps(cfg))
    (tmp_path / "perfbench/mixes/toy_eval.json").write_text(json.dumps(dict(
        toy.mix("vae_base.eval_full"), protocol="fast", generator="perfbench.generators.toy_steps:run")))
    (tmp_path / "perfbench/limits/toy_base.toy_eval.json").write_text(
        (ROOT / "perfbench/limits/vae_base.eval_full.json").read_text())
    (tmp_path / "perfbench/layer_metrics/toy_steps.eval.py").write_text(
        "def read(trace):\n    return float(trace['window']['steps'])\n")
    bench["configs"].append({"name": "toy_base", "source": "https://example.org/toy", "reduced": [],
                             "file": "perfbench/configs/toy_base.json", "why": "a throwaway"})
    bench["workloads"].append({"name": "toy_base.toy_eval", "config": "toy_base", "traffic": "toy_eval",
                               "chips": 1, "why": "a throwaway"})
    bench["end_to_end"][0]["workloads"].append("toy_base.toy_eval")
    bench["per_layer"].append({"name": "toy_steps.eval", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "evaluation step",
                               "moves": "eval_img_per_s", "workloads": ["toy_base.toy_eval"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, time, torch; sys.path.insert(0, sys.argv[1]); from perfbench import harness; "
            "r = harness.run_cell('toy_base.toy_eval', 17, 1.0, False, torch.device('cpu'), time.perf_counter()); "
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
