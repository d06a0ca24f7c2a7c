"""The port's spans and counters (``nope_tpu_torch.utils.profiling``) on
the CPU: off without a profiler, nested under ``profiling.trace`` and in
its Chrome trace; the spans of ``evaluate_geodesic`` and of
``PoseEstimator``; and the benchmark's readers of them
(``perfbench/program_spans.py``) on a synthetic store."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nope_tpu_torch.evaluation.geodesic import evaluate_geodesic
from nope_tpu_torch.geometry import rotations as rot
from nope_tpu_torch.geometry import so3_grid
from nope_tpu_torch.geometry import transforms as tf
from nope_tpu_torch.models.factory import init_weights
from nope_tpu_torch.models.unet import PoseUNet
from nope_tpu_torch.models.vae import StableDiffusionVAE
from nope_tpu_torch.serving import PoseEstimator
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig
from nope_tpu_torch.utils import profiling
from tests.torch_port_helpers import IMG, UNET, VAE

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness, work, work_adm  # noqa: E402

N_GRID = 8


@pytest.fixture(autouse=True)
def empty_store():
    profiling.spans(clear=True)
    yield
    profiling.spans(clear=True)


@pytest.fixture(scope="module")
def task():
    gen = torch.Generator().manual_seed(3)
    unet = init_weights(PoseUNet(**UNET), gen).eval()
    vae = init_weights(StableDiffusionVAE(**VAE), gen).eval()
    return PoseConditionalTask(unet, vae, TaskConfig(half_precision_eval=False))


def _images(seed, n):
    return np.random.default_rng(seed).uniform(-1, 1, (n, IMG, IMG, 3)).astype(np.float32)


def _eval_batch(seed, b):
    rng = np.random.default_rng(seed)
    grid = torch.from_numpy(so3_grid.load_obj_poses(0)[:N_GRID, :3, :3].astype(np.float32))
    query_pose = grid[torch.from_numpy(rng.integers(0, N_GRID, b))]
    all_rel = tf.relative_rotation(grid.expand(b, -1, -1, -1), grid[0].expand(b, N_GRID, 3, 3))
    gt_rel = tf.relative_rotation(query_pose, grid[0].expand(b, 3, 3))
    return {"query": _images(seed + 1, b), "reference": _images(seed + 2, b),
            "gt_relativeR": rot.matrix_to_rotation_6d(gt_rel).numpy(),
            "all_relativeR": rot.matrix_to_rotation_6d(all_rel).numpy(), "query_pose": query_pose.numpy(),
            "template_poses": grid.expand(b, -1, -1, -1).contiguous().numpy(),
            "symmetry": (np.arange(b) % 3).astype(np.int32)}


def _children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent["id"]]


# -- the mechanism ------------------------------------------------------------------------------


def test_without_a_profiler_a_span_records_nothing():
    asked = []
    with profiling.span("off", request=1, facts=lambda: asked.append(1) or {"items": 1}, items=2):
        torch.ones(3).sum()
    assert profiling.spans() == [] and asked == []


def test_a_span_entered_before_the_profile_records_nothing(tmp_path):
    with profiling.span("before"):
        with profiling.trace(str(tmp_path)):
            with profiling.span("inside", request=4):
                pass
    spans = profiling.spans()
    assert [(s["name"], s["parent"], s["request"]) for s in spans] == [("inside", None, 4)]


def test_spans_nest_under_trace_and_reach_the_chrome_trace(tmp_path):
    x = torch.ones(2, 3, dtype=torch.bfloat16)
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", request=7, items=3, shape=(1, 2)):
            with profiling.span("inner", facts=lambda: profiling.batch_facts(x)):
                torch.ones(4).sum()
            with profiling.span("other", request=8):
                pass
        with profiling.span("next"):
            pass
    spans = profiling.spans()
    by_name = {s["name"]: s for s in spans}
    assert [s["name"] for s in spans] == ["outer", "inner", "other", "next"]
    assert by_name["outer"]["attrs"] == {"items": 3, "shape": (1, 2)} and by_name["outer"]["parent"] is None
    assert by_name["inner"]["attrs"] == {"items": 2, "dtype": "bfloat16"}
    assert [(by_name[n]["parent"], by_name[n]["request"]) for n in ("inner", "other", "next")] == [
        (by_name["outer"]["id"], 7), (by_name["outer"]["id"], 8), (None, None)]
    for s in spans:
        assert s["device_ms"] is None and s["host_ms"] == pytest.approx((s["t1_ns"] - s["t0_ns"]) * 1e-6)
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] <= outer["t1_ns"]
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert {"outer", "inner", "other", "next"} <= {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_the_store_is_bounded_and_can_be_cleared(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    dropped = profiling.counters().get("profiling.dropped_spans", 0)
    with profiling.trace(str(tmp_path)):
        for i in range(3):
            with profiling.span("s", request=i):
                pass
    assert [s["request"] for s in profiling.spans(clear=True)] == [0, 1]
    assert profiling.counters()["profiling.dropped_spans"] == dropped + 1 and profiling.spans() == []


def test_counters_are_always_on_and_read_as_a_copy():
    before = profiling.counters().get("test.counted", 0)
    profiling.count("test.counted")
    profiling.count("test.counted", 2)
    table = profiling.counters()
    table["test.counted"] = -1
    assert profiling.counters()["test.counted"] == before + 3


# -- the program's spans ------------------------------------------------------------------------


def test_evaluate_geodesic_spans_each_batch_in_order(task, tmp_path):
    batches = [_eval_batch(s, 2) for s in (1, 2)]
    want = evaluate_geodesic(task, batches, chunk_size=4)
    with profiling.trace(str(tmp_path)):
        got = evaluate_geodesic(task, batches, chunk_size=4)
    assert {k: v for k, v in got.items() if k != "images_per_sec"} == pytest.approx(
        {k: v for k, v in want.items() if k != "images_per_sec"}, nan_ok=True)
    spans = profiling.spans()
    top = [(s["name"], s["request"]) for s in spans if s["parent"] is None]
    phases = ("eval.load", "eval.to_device", "eval.step", "eval.fetch")
    assert top == [(p, i) for i in range(2) for p in phases] + [("eval.load", 2)]  # the last pull ends the loop
    for s in spans:
        if s["name"] == "eval.fetch":
            assert _children(spans, s) == ["eval.wait"]
        if s["name"] == "eval.step":
            assert _children(spans, s) == ["task.loss", "task.sweep", "task.metric"]
        if s["name"] == "task.loss":
            assert _children(spans, s) == ["vae.encode", "vae.encode", "unet"]
        if s["name"] == "task.sweep":  # the bf16-less sweep: two encodes, then N / chunk forwards
            assert _children(spans, s) == ["vae.encode", "vae.encode"] + ["unet"] * (N_GRID // 4)
        if s["name"] == "unet":
            assert s["attrs"]["dtype"] == "float32" and s["attrs"]["items"] in (2, 2 * 4)
            assert set(_children(spans, s)) == {"k3", "k2"}
        if s["name"] == "k3":
            h, w, cin, co, res, emb = s["attrs"]["shape"]
            assert h == w and cin > 0 and co > 0 and isinstance(emb, bool) and res == (cin != co)
            assert work.k3_work(s["attrs"]["shape"], s["attrs"]["items"])[0] > 0
        if s["name"] == "k2":
            dim, tokens = s["attrs"]["shape"]
            assert work.k2_work(dim, tokens, s["attrs"]["items"])[0] > 0
    steps = [s for s in spans if s["name"] == "eval.step"]
    assert [s["request"] for s in spans if s["name"] == "task.loss"] == [0, 1] and len(steps) == 2


def test_pose_estimator_spans_its_calls(task, tmp_path):
    est = PoseEstimator(task, fast_evaluation=True)
    with profiling.trace(str(tmp_path)):
        est.register_objects(["a", "b"], _images(5, 2))
        est.estimate_many(["a", "b", "a"], _images(6, 3))
        est.estimate("b", _images(7, 1)[0])
    spans = profiling.spans()
    top = [s for s in spans if s["parent"] is None]
    assert [(s["name"], s["request"], s["attrs"]["items"]) for s in top] == [
        ("engine.register", 0, 2), ("engine.estimate", 1, 3), ("engine.estimate", 2, 1)]
    assert _children(spans, top[0]) == ["vae.encode", "unet"]
    for call in top[1:]:
        assert _children(spans, call) == ["engine.queries", "engine.stack", "vae.encode", "engine.score",
                                          "engine.wait", "engine.assemble"]
    for s in spans:
        if s["parent"] is not None:
            assert s["request"] in (0, 1, 2)


# -- the benchmark's readers --------------------------------------------------------------------

K3_SHAPE, K2_SHAPE = (32, 32, 192, 192, False, True), (384, 64)
ADM_SHAPE = (16, 16, 256, 512, True, "down")


def _store():
    """A synthetic store of an eval window and of serving calls."""
    spans = []

    def add(name, parent=None, request=None, t0=0.0, t1=0.0, device=None, **attrs):
        spans.append({"name": name, "id": len(spans), "parent": parent, "request": request, "attrs": attrs,
                      "t0_ns": int(t0 * 1e6), "t1_ns": int(t1 * 1e6), "host_ms": t1 - t0, "device_ms": device})
        return len(spans) - 1

    k3_least = work.bound(*work.k3_work(K3_SHAPE, 10))[0]
    k2_least = work.bound(*work.k2_work(*K2_SHAPE, 10))[0]
    adm_least = work.bound(*work_adm.res_work(ADM_SHAPE, 10))[0]
    for r, (start, end, loss) in enumerate([(0.0, 100.0, 200.0), (130.0, 220.0, 300.0), (240.0, 330.0, 250.0)]):
        step = add("eval.step", request=r, t0=start, t1=start + 5)
        add("task.loss", step, r, device=loss)
        unet = add("unet", step, r, device=120.0 if r % 2 else 130.0, items=1000, dtype="bfloat16")
        fp32_unet = add("unet", step, r, device=50.0, items=64, dtype="float32")
        add("adm.res", unet, r, device=2 * adm_least, items=10, dtype="bfloat16", shape=ADM_SHAPE)
        add("adm.res", unet, r, device=6 * adm_least, items=10, dtype="bfloat16", shape=ADM_SHAPE)
        add("adm.res", fp32_unet, r, device=1.0, items=10, dtype="float32", shape=ADM_SHAPE)
        add("adm.attn", unet, r, device=3.0, items=10, dtype="bfloat16", shape=(16, 512, 8))
        add("adm.attn", fp32_unet, r, device=9.0, items=10, dtype="float32", shape=(16, 512, 8))
        add("k3", unet, r, device=2 * k3_least, items=10, dtype="bfloat16", shape=K3_SHAPE)
        add("k3", unet, r, device=1.0, items=10, dtype="float32", shape=K3_SHAPE)
        add("k2", unet, r, device=4 * k2_least, items=10, dtype="bfloat16", shape=K2_SHAPE)
        add("vae.encode", step, r, device=320.0, items=64, dtype="float32")
        add("vae.encode", step, r, device=64.0, items=64, dtype="bfloat16")
        fetch = add("eval.fetch", request=r, t0=end - 1, t1=end + 20)
        add("eval.wait", fetch, r, t0=end - 1, t1=end)
    # between steps: 130 - 100 and 240 - 220; the last wait has no next step
    reg = add("engine.register", request=10, t0=0.0, t1=5.0, device=50.0, items=1)
    add("unet", reg, 10, device=40.92, items=341, dtype="bfloat16")
    add("vae.encode", reg, 10, device=2.0, items=1, dtype="bfloat16")
    for r, (host, wait) in enumerate([(10.0, 4.0), (8.0, 2.0)], 11):
        call = add("engine.estimate", request=r, t0=0.0, t1=host, items=4)
        add("vae.encode", call, r, device=8.0, items=4, dtype="bfloat16")
        add("engine.wait", call, r, t0=1.0, t1=1.0 + wait)
    return spans


VAE_MS = (3 * (320.0 + 64.0) + 2.0 + 2 * 8.0) / (3 * 128 + 1 + 2 * 4)
EXPECTED = {
    "loss_ms_per_step.eval": 250.0,
    "between_steps_ms.eval": 25.0,
    "unet_span_ms_per_kitem.eval": 1000.0 * (130.0 + 120.0 + 130.0 + 40.92) / 3341,
    "vae_span_ms_per_img.eval": VAE_MS,
    "k3_span_roofline.eval": 50.0,
    "k2_span_roofline.eval": 25.0,
    "estimate_host_ms.serve": 6.0,
    "service_ms.serve": (10.0 + 8.0 + 50.0) / 3,
    "unet_span_ms_per_kitem.register": 120.0,
    "vae_span_ms_per_img.serve": VAE_MS,
    # the bf16 blocks' ms per 1,000 items of the bf16 unet spans that hold them
    "adm_res_ms_per_kitem.eval": 1000.0 * 3 * 8 * work.bound(*work_adm.res_work(ADM_SHAPE, 10))[0] / 3000,
    "adm_attn_ms_per_kitem.eval": 3.0,
    "adm_res_roofline.eval": 25.0,
}
TRACE = {"spans": {}, "profile": {"busy_s": 1.0, "window_s": 1.0}, "window": {}}


def test_every_span_metric_of_the_benchmark_is_tested_here():
    added = {m["name"] for m in harness.spec()["per_layer"]
             if "program_spans" in (harness.HERE / "layer_metrics" / f"{m['name']}.py").read_text()}
    assert added == set(EXPECTED)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_span_reader_reads_a_synthetic_store(monkeypatch, metric):
    monkeypatch.setattr(profiling, "spans", _store)
    assert harness.reader(metric)(TRACE) == pytest.approx(EXPECTED[metric], rel=1e-9)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_span_reader_finds_nothing_in_an_empty_store(monkeypatch, metric):
    read = harness.reader(metric)
    assert read(TRACE) is None  # the store is empty
    monkeypatch.setattr(profiling, "spans", _store)
    assert read(dict(TRACE, profile=None)) is None  # no profiled sub-window
    monkeypatch.delattr(profiling, "spans")  # a program from before the spans
    assert read(TRACE) is None
