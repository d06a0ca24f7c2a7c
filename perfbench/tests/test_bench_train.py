"""The training cell's yardstick on the CPU: the training reference
against the port's train step, the written root against the port's
reader, the TF32 rounding of the control, the step's FLOP count, the
judge's numbers, the host-clock readers, and whole small runs: sound,
under the control and under each planted fault.

The cell is not in ``BENCHMARK.json``: on the card's shared host its
rate swings past any bound a check can hold (PERF.md), so these tests
add it to a copy of the spec, as ``BENCHMARK.json`` will once it holds."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import check, harness, inputs, shapenet_root
from perfbench.generators import train_steps
from perfbench.reference import lowp
from perfbench.reference import train as ref_train
from perfbench.tests import toy

CELL = {"name": "vae_base.train", "config": "vae_base", "traffic": "train", "chips": 1,
        "why": "Trainer.fit, fp32, AdamW in its warm-up, 512-px PNGs through the thread loader"}


def bench() -> dict:
    """``BENCHMARK.json`` with the training cell appended to its workloads."""
    spec = harness.spec()
    return dict(spec, workloads=spec["workloads"] + [CELL])


def small_mix() -> dict:
    return dict(harness.load_json(harness.HERE / "mixes" / f"{CELL['traffic']}.json"),
                **harness.load_json(toy.own_file("toy_mixes", "train_steps", ".json")))


def small_run(seed: int = 2**31 + 11, seconds: float = 1.0) -> dict:
    return harness.run_cell(CELL["name"], seed, seconds, False, torch.device("cpu"), time.perf_counter(), bench(),
                            toy.config(CELL["config"]), small_mix())


OPTIM = {"lr": 5e-5, "weight_decay": 5e-4, "warm_up_steps": 500, "betas": [0.9, 0.999], "eps": 1e-8}


def _batch(gen: np.random.Generator, b: int, img: int) -> dict:
    grid = shapenet_root.grid_poses()[:, :3, :3]
    q, r = grid[gen.integers(0, len(grid), b)], grid[gen.integers(0, len(grid), b)]
    rel = q @ np.transpose(r, (0, 2, 1))
    return {"query": torch.from_numpy(gen.integers(0, 256, (b, img, img, 3), dtype=np.uint8)),
            "reference": torch.from_numpy(gen.integers(0, 256, (b, img, img, 3), dtype=np.uint8)),
            "relativeR": torch.from_numpy(inputs.rotation_6d(rel).astype(np.float32)),
            "relativeR_inv": torch.from_numpy(inputs.rotation_6d(np.transpose(rel, (0, 2, 1))).astype(np.float32))}


def test_the_training_reference_follows_the_ports_train_step():
    """Three AdamW steps of the port's train step (``make_train_step`` over
    ``make_optimizer``'s AdamW in its warm-up) and of the reference, from
    one seeded state on the same batches.  Both run plain float32 on the
    CPU, so they differ only in the order of their sums: the losses by a
    few float32 ulps (limit 1e-6), the first gradients' norms a leaf by
    under 1e-5 of the larger of the leaf's and the median leaf's, the
    weights' change after three steps by under 1e-3 (AdamW divides by
    sqrt(v), which amplifies the gradients' rounding where they are
    small)."""
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig
    from nope_tpu_torch.training.optim import make_optimizer
    from nope_tpu_torch.training.train_state import TrainState, make_train_step

    cfg, device = toy.config("vae_base"), torch.device("cpu")
    state = inputs.state_for(cfg, 7, device)
    prog = inputs.load(inputs.meta_modules(cfg, "program"), state, device)
    want = inputs.load(inputs.meta_modules(cfg, "reference"), state, device, frozen=True)
    gen = inputs.rng(7, 1)
    steps = [{"shapeNet": _batch(gen, 3, cfg["img_size"])} for _ in range(3)]

    task = PoseConditionalTask(prog["unet"], prog["vae"], TaskConfig(**cfg["task"]))
    start = {n: p.detach().clone() for n, p in task.unet.named_parameters()}
    opt = make_optimizer(task.unet.parameters(), base_lr=OPTIM["lr"], weight_decay=OPTIM["weight_decay"],
                         warm_up_steps=OPTIM["warm_up_steps"])
    train_state, step = TrainState(0, task.unet, task.vae, opt), make_train_step(task)
    got = {"losses": []}
    for i, batches in enumerate(steps):
        train_state, metrics = step(train_state, batches)
        got["losses"].append(float(metrics["loss/train_avg"]))
        if i == 0:
            got["grad_norms"] = train_steps.first_moment_norms(opt, task.unet, OPTIM["betas"][0])
    got["change_norms"] = {n: float(torch.linalg.vector_norm((p.detach() - start[n]).double()))
                           for n, p in task.unet.named_parameters()}

    followed = ref_train.adamw_steps(want["unet"], want["vae"], steps, OPTIM, device)
    assert got["grad_norms"].keys() == followed["grad_norms"].keys()
    assert followed["losses"][0] > 0 and all(v > 0 for v in followed["change_norms"].values())
    readings = train_steps.compare(got, followed)
    assert readings["loss_rel"] <= 1e-6, readings
    assert readings["grad_gap"] <= 1e-5, readings
    assert readings["change_gap"] <= 1e-3, readings


def test_the_judge_reads_a_state_left_unchanged_and_halved_gradients():
    want = {"losses": [1.0, 0.9, 0.8], "grad_norms": {"a": 2.0, "b": 1.0, "c": 1e-9},
            "change_norms": {"a": 3e-7, "b": 2e-7, "c": 1e-7}}
    unchanged = dict(want, change_norms=dict.fromkeys(want["change_norms"], 0.0))
    assert train_steps.compare(want, want) == {"loss_rel": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    assert train_steps.compare(unchanged, want)["change_gap"] == 1.0
    halved = dict(want, grad_norms={k: v / 2 for k, v in want["grad_norms"].items()})
    assert train_steps.compare(halved, want)["grad_gap"] == 0.5
    # "c"'s gradient is under a thousandth of the median leaf's: its change is round-off and not counted
    moved = dict(want, change_norms=dict(want["change_norms"], c=1.0))
    assert train_steps.compare(moved, want)["change_gap"] == 0.0
    assert train_steps.compare(dict(want, losses=[1.0]), want)["loss_rel"] == float("inf")


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest_even():
    exact = torch.tensor([1.0, -1.5, 1.0 + 2.0**-10, 2.0**-66 * 1.75, 0.0])
    assert torch.equal(lowp.tf32_round(exact), exact)
    halfway = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -(1.0 + 2.0**-11)])
    assert torch.equal(lowp.tf32_round(halfway), torch.tensor([1.0, 1.0 + 2 * 2.0**-10, -1.0]))
    x = torch.randn(10_000, generator=torch.Generator().manual_seed(0))
    rel = ((lowp.tf32_round(x) - x) / x).abs().max()
    assert 2.0**-12 < rel <= 2.0**-11
    assert (lowp.tf32_round(x).view(torch.int32) & 0x1FFF).eq(0).all()
    x.requires_grad_(True)
    lowp.tf32_round(x).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))  # the rounding passes gradients straight through


def test_the_control_rounds_every_product_only_where_tf32_is_on():
    a, b = torch.randn(4, 5, generator=torch.Generator().manual_seed(1)), torch.randn(5, 3)
    rounded = torch.matmul(lowp.tf32_round(a), lowp.tf32_round(b))
    assert not torch.equal(torch.matmul(a, b), rounded)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with lowp.tf32():
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        assert torch.equal(torch.matmul(a, b), rounded) and torch.equal(a @ b, rounded)
        assert torch.equal(torch.nn.functional.linear(a, b.T), rounded)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved
    assert torch.equal(torch.matmul(a, b), a.matmul(b)) and not torch.equal(torch.matmul(a, b), rounded)


def test_the_written_root_reads_as_the_training_split(tmp_path):
    from nope_tpu_torch.data.shapenet import ShapeNetDataset, decode_png

    spec = dict(small_mix()["root"], queries=3, references=2, distinct_images=2)
    info = shapenet_root.write(tmp_path / "root", spec, 2**31 + 5)
    assert len(info["views"]) == 8 and info["queries"] == 24 and len(info["pool"]) == 2
    ds = ShapeNetDataset(str(tmp_path / "root"), "training", img_size=32)
    assert len(ds) == 24
    assert sorted(ds.query_to_references) == [f"obj_{i:06d}" for i in sorted(info["views"])]
    item = ds[5]
    assert item["query"].shape == (32, 32, 3) and item["query"].std() > 0
    png = decode_png(str(tmp_path / "root" / "pool" / "000.png"))
    assert png.shape == (512, 512, 4) and png.dtype == np.uint8
    again = tmp_path / "again"
    shapenet_root.write(again, spec, 2**31 + 5)
    assert (again / "pool" / "001.png").read_bytes() == (tmp_path / "root" / "pool" / "001.png").read_bytes()


def test_the_reference_crop_follows_the_ports_at_every_grid_pose(tmp_path):
    """The reference's homography equals the port's ``crop_homography`` at
    each of the 642 grid poses, the two whose up hint lies along the line
    of sight (0 and 641) among them; its crops of a written view sit within
    the 8 levels that a warp weighting in 1/32 pixel (cv2's) makes at the
    images' 254-level cell edges."""
    from nope_tpu_torch.data.shapenet import ShapeNetDataset
    from nope_tpu_torch.geometry.cropping import crop_homography

    from perfbench.reference import crop as ref_crop

    grid = shapenet_root.grid_poses()
    for pose in grid:
        want = crop_homography(ref_crop.SHAPENET_K, pose, 256, virtual_bbox_size=1.0)
        assert np.array_equal(ref_crop.homography(pose, 256), want)
    spec = dict(small_mix()["root"], queries=1, references=1, distinct_images=1)
    info = shapenet_root.write(tmp_path / "root", spec, 2**31 + 9)
    ds = ShapeNetDataset(str(tmp_path / "root"), "training", img_size=64)
    for g in (0, 17, 333, 641):
        got = ds._crop(ds.open_image(str(tmp_path / "root" / "pool" / "000.png")), grid[g])
        want = ref_crop.crop(info["pool"][0], grid[g], 64)
        assert got.shape == want.shape and np.abs(got.astype(int) - want).max() <= 8, g


def test_a_training_step_counts_its_flops():
    cfg = harness.load_json(harness.HERE / "configs" / "vae_base.json")
    # 16 pairs: 32 U-Net items forward and backward (105.11 GFLOP each) and 32 SD-VAE encodes (272.72)
    assert train_steps.step_flops(cfg, 16) / 1e12 == pytest.approx(12.0904, abs=5e-5)


def test_the_loader_wait_reader_and_the_timed_loader():
    read = harness.reader("loader_wait_pct.train")
    assert read({"window": {"seconds": 8.0, "loader_wait_s": 2.0}, "spans": {}, "profile": None}) == 25.0
    assert read({"window": {"seconds": 8.0}, "spans": {}, "profile": None}) is None
    read = harness.reader("step_host_ms.train")
    assert read({"window": {"steps": 4, "step_call_s": 1.0}, "spans": {}, "profile": None}) == 250.0
    assert read({"window": {"steps": 0, "step_call_s": 0.0}, "spans": {}, "profile": None}) is None

    class Slow:
        def __len__(self):
            return 3

        def __iter__(self):
            for i in range(3):
                time.sleep(0.02)
                yield i

    waits = []
    assert list(train_steps.TimedLoader(Slow(), waits)) == [0, 1, 2]
    assert len(waits) == 3 and all(e - s >= 0.015 for s, e in waits)


def test_the_cell_runs_small_in_a_fresh_process_without_jax():
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); from perfbench.tests.test_bench_train import small_run; "
            "from perfbench.run import forbidden_modules; r = small_run(); "
            "print(json.dumps({'result': r, 'forbidden': forbidden_modules()}))")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)], capture_output=True, text=True, timeout=600,
                         check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["forbidden"] == []
    result = line["result"]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == {"loss_rel", "grad_gap", "change_gap", "data_gap", "failed_calls"}


def test_the_control_comes_out_not_correct():
    device = torch.device("cpu")
    files, run, outcome, _ = harness.drive(CELL["name"], 2**31 + 3, 1.0, False, device, time.perf_counter(), bench(),
                                           toy.config(CELL["config"]), small_mix())
    side = harness.side(run.cfg, "reference", 2**31 + 3, device)
    limits = harness.load_json(files["limits"])["limits"]
    assert check.verdict(outcome.check(side), limits)[0]
    assert not check.verdict(outcome.check(side, harness.side(run.cfg, "control", 2**31 + 3, device)), limits)[0]


@pytest.mark.parametrize("fault", toy.faults_of("train_steps"), ids=lambda f: f.__name__)
def test_a_planted_fault_comes_out_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert small_run(seconds=2.0)["correct"] is False


def test_the_generator_plants_three_faults_or_more():
    faults = toy.faults_of("train_steps")
    assert len(faults) >= 3 and len({f.__name__ for f in faults}) == len(faults)
