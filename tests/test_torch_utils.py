"""The port's ``utils`` (``nope_tpu_torch.utils``: ``visualization``,
``inout``, ``logging``, ``vis_3d``, ``profiling``) against ``nope_tpu.utils``
on the same seeded inputs: host arrays and written files equal exactly;
the JAX package's own tests of each module rerun on the port."""

import json
import logging
import os.path as osp
import sys
import types

import numpy as np
import pytest
import torch

from nope_tpu.utils import inout as jinout
from nope_tpu.utils import logging as jlog
from nope_tpu.utils import vis_3d as jvis3d
from nope_tpu.utils import visualization as jvis
from nope_tpu_torch.utils import inout, profiling, vis_3d, visualization
from nope_tpu_torch.utils import logging as nlog


# -- visualization ------------------------------------------------------------------


def test_similarity_heatmap_matches():
    rng = np.random.default_rng(0)
    for sim in (np.linspace(-3, 5, 41), rng.normal(size=(26,)), rng.uniform(0, 1, (7, 5))):
        got = visualization.similarity_heatmap(sim)
        np.testing.assert_array_equal(got, jvis.similarity_heatmap(sim))
    colors = visualization.similarity_heatmap(np.linspace(-3, 5, 41))
    assert colors.shape == (41, 3) and colors.min() >= 0.0 and colors.max() <= 1.0
    assert colors.sum(1)[0] < colors.sum(1)[-1]  # monotone brightness along the colormap


@pytest.mark.parametrize("apply_cmap", [True, False])
def test_visualize_uncertainty_matches(apply_cmap):
    u = np.random.default_rng(1).uniform(0, 1, (2, 4, 4, 4)).astype(np.float32)
    got = visualization.visualize_uncertainty(u, (16, 16), apply_cmap=apply_cmap)
    np.testing.assert_array_equal(got, jvis.visualize_uncertainty(u, (16, 16), apply_cmap=apply_cmap))
    assert got.shape == (2, 16, 16, 3)
    if not apply_cmap:  # RGB replication of the channel norm
        np.testing.assert_array_equal(got[..., 0], got[..., 2])


def test_write_text_on_grid_matches(tmp_path):
    from PIL import Image

    canvas = np.random.default_rng(2).integers(0, 60, (32, 48, 3), dtype=np.uint8)
    p = str(tmp_path / "grid.png")
    Image.fromarray(canvas).save(p)
    for kw in ({"idx_cols": [1]}, {"idx_cols": [0, 2], "additional_info": [1.5, 2.5, 3.5, 4.5]}):
        errors = [12.3, 45.6, 7.8, 9.1]
        got = visualization.write_text_on_grid(p, errors=errors, sample_size=16, **kw)
        np.testing.assert_array_equal(got, jvis.write_text_on_grid(p, errors=errors, sample_size=16, **kw))
        assert got.shape == (32, 48, 3) and (got != canvas).any()  # text pixels were stamped


def test_draw_pose_axes_matches():
    rng = np.random.default_rng(3)
    from scipy.spatial.transform import Rotation

    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    K = np.array([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, :3] = Rotation.random(random_state=4).as_matrix()
    pose[:3, 3] = [0.02, -0.01, 0.6]
    got = visualization.draw_pose_axes(img, K, pose, length=0.1)
    np.testing.assert_array_equal(got, jvis.draw_pose_axes(img, K, pose, length=0.1))
    assert got.shape == img.shape and got.dtype == np.float32


def test_write_video_decodes_to_the_same_frames(tmp_path):
    import imageio

    rng = np.random.default_rng(5)
    frames = [rng.uniform(0, 1, (16, 16, 3)).astype(np.float32) for _ in range(3)]
    frames.append(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    got = visualization.write_video(frames, str(tmp_path / "port" / "sweep.gif"), fps=5)
    want = jvis.write_video(frames, str(tmp_path / "jax" / "sweep.gif"), fps=5)
    a, b = imageio.mimread(got), imageio.mimread(want)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# -- inout -----------------------------------------------------------------------------


def test_inout_roundtrip_and_files_match(tmp_path):
    obj = {"a": np.float32(1.5), "b": np.arange(3), "c": np.bool_(True), "d": [np.int64(4)]}
    for mod, sub in ((inout, "port"), (jinout, "jax")):
        (tmp_path / sub).mkdir()
        mod.save_json(str(tmp_path / sub / "x.json"), obj)
        mod.write_txt(str(tmp_path / sub / "x.txt"), ["a", "", "b", 3])
        mod.save_npz(str(tmp_path / sub / "deep" / "x.npz"), q=np.arange(4.0))
    for name in ("x.json", "x.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert inout.load_json(str(tmp_path / "port" / "x.json")) == {"a": 1.5, "b": [0, 1, 2], "c": True, "d": [4]}
    assert inout.open_txt(str(tmp_path / "port" / "x.txt")) == ["a", "b", "3"]
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "deep" / "x.npz")["q"], np.arange(4.0))
    with pytest.raises(TypeError, match="not JSON serializable"):
        inout.save_json(str(tmp_path / "bad.json"), {"x": object()})
    assert inout.get_root_project() == jinout.get_root_project()


# -- logging ------------------------------------------------------------------------------


def test_configure_preset_job_logging_split(tmp_path):
    """``custom``: logs.out carries INFO/DEBUG only, logs.err WARNING and
    above only; ``console`` writes no files; ``rich`` takes RichHandler where
    rich imports and a plain stream handler where it does not, as JAX's."""
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    try:
        nlog.configure_preset("custom", log_dir=str(tmp_path))
        log = logging.getLogger("preset_probe")
        log.info("info-line")
        log.error("error-line")
        for h in root.handlers:
            h.flush()
        out, err = (tmp_path / "logs.out").read_text(), (tmp_path / "logs.err").read_text()
        assert "info-line" in out and "error-line" not in out
        assert "error-line" in err and "info-line" not in err
        with pytest.raises(ValueError, match="unknown job_logging"):
            nlog.configure_preset("nope")
        nlog.configure_preset("console", log_dir=str(tmp_path / "console"))
        assert not (tmp_path / "console").exists() and len(root.handlers) == 1
        kinds = {}
        for name, mod in (("port", nlog), ("jax", jlog)):
            mod.configure_preset("rich", log_dir=str(tmp_path / name))
            kinds[name] = [type(h).__name__ for h in root.handlers]
            sys.modules["rich"] = sys.modules["rich.logging"] = None
            try:
                mod.configure_preset("rich", log_dir=str(tmp_path / name))
                kinds[name + " no rich"] = [type(h).__name__ for h in root.handlers]
            finally:
                del sys.modules["rich"], sys.modules["rich.logging"]
        assert kinds["port"] == kinds["jax"] and kinds["port no rich"] == kinds["jax no rich"]
        assert kinds["port no rich"][0] == "StreamHandler"
        nlog.configure(logging.DEBUG, log_file=str(tmp_path / "run.log"))
        logging.getLogger("configure_probe").debug("debug-line")
        for h in root.handlers:
            h.flush()
        assert "debug-line" in (tmp_path / "run.log").read_text()
    finally:
        for h in root.handlers:
            h.close()
        root.handlers[:], root.level = saved


def test_levels_filter_stream_to_logger_and_tqdm_handler(capsys):
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((record.levelno, record.getMessage()))

    log = logging.getLogger("port_stream_probe")
    log.propagate, log.level = False, logging.DEBUG
    keep = Keep()
    keep.addFilter(nlog.LevelsFilter(["INFO", "ERROR"]))
    log.addHandler(keep)
    tq = nlog.TqdmLoggingHandler()
    tq.setFormatter(logging.Formatter("%(message)s"))
    log.addHandler(tq)
    try:
        stream = nlog.StreamToLogger(log, logging.INFO)
        stream.write("first line\nsecond line  \n")
        stream.flush()
        log.warning("dropped by the filter")
        log.error("kept")
    finally:
        log.removeHandler(keep)
        log.removeHandler(tq)
    assert records == [(logging.INFO, "first line"), (logging.INFO, "second line"), (logging.ERROR, "kept")]
    assert capsys.readouterr().out.splitlines() == ["first line", "second line", "dropped by the filter", "kept"]


# -- vis_3d ----------------------------------------------------------------------------------


def _stub_open3d():
    """An ``open3d`` module that records what it is given."""
    calls = []

    class Geom:
        def __init__(self, kind, **kw):
            self.kind, self.kw = kind, kw
            calls.append(("new", kind, {k: np.asarray(v).copy() for k, v in kw.items()}))

        def __setattr__(self, name, value):
            object.__setattr__(self, name, value)
            if name not in ("kind", "kw"):
                calls.append(("set", self.kind, name, np.asarray(value).copy()))

    o3d = types.ModuleType("open3d")
    o3d.utility = types.SimpleNamespace(Vector3dVector=lambda a: np.array(a, dtype=np.float64),
                                        Vector2iVector=lambda a: np.array(a, dtype=np.int64))
    o3d.geometry = types.SimpleNamespace(
        PointCloud=lambda: Geom("PointCloud"),
        LineSet=lambda **kw: Geom("LineSet", **kw),
        TriangleMesh=types.SimpleNamespace(create_coordinate_frame=lambda size: Geom("Frame", size=size)))
    o3d.visualization = types.SimpleNamespace(draw_geometries=lambda geoms: calls.append(("draw", len(geoms))))
    return o3d, calls


def _equal_calls(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:2] == y[:2] and len(x) == len(y)
        if x[0] == "new":
            assert x[2].keys() == y[2].keys()
            for k in x[2]:
                np.testing.assert_array_equal(x[2][k], y[2][k])
        elif x[0] == "set":
            assert x[2] == y[2]
            np.testing.assert_array_equal(x[3], y[3])


def test_vis_3d_needs_open3d_and_matches_under_a_stub(monkeypatch):
    monkeypatch.setitem(sys.modules, "open3d", None)
    for call in (lambda: vis_3d.convert_numpy_to_open3d(np.zeros((2, 3))),
                 lambda: vis_3d.draw_camera(np.eye(4)), lambda: vis_3d.draw_pose_grid(0)):
        with pytest.raises(ImportError):
            call()
    rng = np.random.default_rng(6)
    pts, cols = rng.normal(size=(9, 3)).astype(np.float32), rng.uniform(0, 1, (9, 3))
    cam = np.eye(4)
    cam[:3, 3] = [0.1, -0.2, 0.5]
    recorded = []
    for mod in (vis_3d, jvis3d):
        o3d, calls = _stub_open3d()
        monkeypatch.setitem(sys.modules, "open3d", o3d)
        mod.convert_numpy_to_open3d(pts, cols)
        mod.convert_numpy_to_open3d(pts)
        mod.draw_camera(cam, scale=0.2, color=(0.0, 1.0, 0.0))
        mod.draw_pose_grid(0, "upper")
        mod.draw_pose_grid(1, "all")
        recorded.append(calls)
    _equal_calls(*recorded)
    draws = [c for c in recorded[0] if c[0] == "draw"]
    assert draws == [("draw", 27), ("draw", 163)]  # level 0 "upper": 26 cameras, level 1: 162; and a frame


# -- profiling ---------------------------------------------------------------------------------


def test_benchmark_helper():
    """JAX's test on the port: keys, iteration count and ordering."""
    stats = profiling.benchmark(lambda x: torch.sum(x * 2), torch.ones(128), iters=3, warmup=1)
    assert set(stats) == {"mean_s", "min_s", "max_s", "iters"} and stats["iters"] == 3.0
    assert 0 < stats["min_s"] <= stats["mean_s"] <= stats["max_s"]
    calls = []
    profiling.benchmark(lambda a, b=0: calls.append((a, b)), 1, b=2, iters=4, warmup=2)
    assert calls == [(1, 2)] * 6


def test_block_until_ready_walks_the_result(monkeypatch):
    """Every CUDA device holding a tensor of the result is synchronised,
    through nested tuples, lists and dicts; CPU tensors need none."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))

    class FakeCuda(torch.Tensor):  # a host tensor that reports a CUDA device
        @property
        def is_cuda(self):
            return True

        @property
        def device(self):
            return self._fake_device

    def cuda(i):
        t = torch.Tensor._make_subclass(FakeCuda, torch.ones(1))
        t._fake_device = torch.device("cuda", i)
        return t

    tree = {"x": [cuda(0), (torch.ones(2), {"y": cuda(1)})], "r": (cuda(0), np.ones(2)), "n": None}
    assert profiling.block_until_ready(tree) is tree
    assert sorted(str(d) for d in synced) == ["cuda:0", "cuda:1"]
    synced.clear()
    profiling.block_until_ready((torch.ones(3), [np.zeros(1)], {"k": 1.0}))
    assert synced == []


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.mm(torch.ones(32, 32), torch.ones(32, 32)).sum()
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" and e.get("cat") == "cpu_op" for e in events)


def test_device_memory_stats_without_a_card():
    assert not torch.cuda.is_available()
    assert profiling.device_memory_stats() == {}


def test_device_memory_stats_reads_the_allocator(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {"allocated_bytes.all.current": 10 + i,
                                                               "allocated_bytes.all.peak": 20 + i,
                                                               "reserved_bytes.all.current": 99})
    assert profiling.device_memory_stats() == {"cuda:0": {"bytes_in_use": 10, "peak_bytes_in_use": 20},
                                               "cuda:1": {"bytes_in_use": 11, "peak_bytes_in_use": 21}}

