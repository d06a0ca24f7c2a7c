"""The port's VSD host path against ``nope_tpu``'s: the numpy rasteriser
and its renderer (depths equal) on a box and a seeded random mesh, the
OBJ and PLY loaders (ASCII and binary), the VSD metric, the frame error
and the batch over a process pool (1e-12), the renderer choice with
pyrender and trimesh blocked, and the 16-bit depth read without cv2."""

import struct
import sys

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from nope_tpu.evaluation import raster as jraster
from nope_tpu.evaluation import vsd as jvsd
from nope_tpu.evaluation import vsd_metrics as jmetrics
from nope_tpu_torch.data.png import write_png
from nope_tpu_torch.evaluation import raster, vsd, vsd_metrics

K = np.array([[300.0, 0.0, 40.0], [0.0, 300.0, 30.0], [0.0, 0.0, 1.0]])
SHAPE = (60, 80)
TOL = 1e-12


@pytest.fixture(autouse=True)
def no_gl(monkeypatch):
    """pyrender and trimesh absent for both packages, whatever an earlier
    test of this worker left in ``sys.modules``."""
    for name in ("pyrender", "trimesh", "nope_tpu.utils.mesh"):
        monkeypatch.setitem(sys.modules, name, None)


def _pose(seed, dist=500.0):
    pose = np.eye(4)
    pose[:3, :3] = Rotation.random(random_state=seed).as_matrix()
    pose[:3, 3] = [5.0 * (seed % 3 - 1), -4.0, dist]
    return pose


def _random_mesh(seed, n_verts=40, n_faces=60):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n_verts, 3)) * 40.0, rng.integers(0, n_verts, (n_faces, 3)).astype(np.int32)


def _write_obj(path, verts, faces):
    with open(path, "w") as fh:
        for v in verts:
            fh.write("v " + " ".join(repr(float(x)) for x in v) + "\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def _write_ply(path, verts, faces, binary):
    header = [b"ply", b"format " + (b"binary_little_endian" if binary else b"ascii") + b" 1.0",
              b"element vertex %d" % len(verts), b"property double x", b"property double y", b"property double z",
              b"property uchar red", b"element face %d" % len(faces), b"property list uchar int vertex_indices",
              b"element extra 2", b"property float w", b"end_header"]
    with open(path, "wb") as fh:
        fh.write(b"\n".join(header) + b"\n")
        if binary:
            for v in verts:
                fh.write(struct.pack("<dddB", *v, 7))
            for f in faces:
                fh.write(struct.pack("<Biiii", 4, f[0], f[1], f[2], f[0]))  # a quad: fan-triangulated
            fh.write(struct.pack("<ff", 1.0, 2.0))
        else:
            for v in verts:
                fh.write((" ".join(repr(float(x)) for x in v) + " 7\n").encode())
            for f in faces:
                fh.write(f"4 {f[0]} {f[1]} {f[2]} {f[0]}\n".encode())
            fh.write(b"1.0\n2.0\n")


@pytest.mark.parametrize("mesh", ["box", "random"])
def test_rasteriser_matches(mesh):
    verts, faces = raster.box_mesh((60.0, 80.0, 100.0)) if mesh == "box" else _random_mesh(0)
    if mesh == "box":
        jv, jf = jraster.box_mesh((60.0, 80.0, 100.0))
        np.testing.assert_array_equal(verts, jv)
        np.testing.assert_array_equal(faces, jf)
    poses = np.stack([_pose(s) for s in range(4)] + [_pose(9, dist=60.0)])  # the last partly behind the camera
    for pose in poses:
        got = raster.rasterize_depth(verts, faces, pose, K, SHAPE)
        np.testing.assert_array_equal(got, jraster.rasterize_depth(verts, faces, pose, K, SHAPE))
    assert (raster.rasterize_depth(verts, faces, poses[0], K, SHAPE) > 0).sum() > 100
    got = raster.NumpyDepthRenderer(verts, faces)(poses, K, SHAPE)
    want = jraster.NumpyDepthRenderer(verts, faces)(poses, K, SHAPE)
    assert len(got) == len(want) == len(poses)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(raster.sample_surface(verts, faces, 50, np.random.default_rng(3)),
                                  jraster.sample_surface(verts, faces, 50, rng))


@pytest.mark.parametrize("fmt", ["obj", "ply-ascii", "ply-binary"])
def test_mesh_loaders_match(fmt, tmp_path):
    verts, faces = _random_mesh(1, n_verts=12, n_faces=10)
    path = str(tmp_path / ("m.obj" if fmt == "obj" else "m.ply"))
    if fmt == "obj":
        _write_obj(path, verts, faces)
    else:
        _write_ply(path, verts, faces, binary=fmt == "ply-binary")
    got, want = raster.load_mesh_arrays(path), jraster.load_mesh_arrays(path)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], verts)
    n_tri = 1 if fmt == "obj" else 2  # a PLY quad makes two triangles
    assert got[1].shape == (len(faces) * n_tri, 3) and got[1].dtype == np.int32
    np.testing.assert_array_equal(raster.NumpyDepthRenderer.from_file(path).faces, got[1])
    with pytest.raises(ValueError, match="unsupported mesh format"):
        raster.load_mesh_arrays(str(tmp_path / "m.stl"))


def _frame(tmp_path, cad_path, verts, faces, seed):
    """A frame whose test depth is the GT render with a nearer occluder
    and a hole (missing depth), stored as 16-bit PNG in 0.1 mm."""
    gt = _pose(seed)
    depth = raster.rasterize_depth(verts, faces, gt, K, SHAPE)
    depth[10:25, 30:50] = np.where(depth[10:25, 30:50] > 0, depth[10:25, 30:50] - 40.0, 0.0)
    depth[40:45, 10:20] = 0.0
    path = str(tmp_path / f"depth_{seed}.png")
    write_png(path, np.round(depth / 0.1).astype(np.uint16))
    pred = np.stack([gt, _pose(seed + 10), _pose(seed + 20), gt @ np.diag([1.0, -1.0, -1.0, 1.0])])
    pred[:, :3, 3] += [3.0, 0.0, 0.0]  # the frame error takes the GT translation
    return vsd.VSDFrame(cad_path=cad_path, intrinsic=K, depth_path=path, pred_poses=pred, gt_pose=gt)


def _jax_frame(frame):
    return jvsd.VSDFrame(**{f: getattr(frame, f) for f in ("cad_path", "intrinsic", "depth_path", "pred_poses",
                                                             "gt_pose", "depth_scale")})


def test_vsd_metric_matches():
    rng = np.random.default_rng(5)
    d_test = rng.uniform(400, 600, SHAPE) * (rng.uniform(size=SHAPE) > 0.1)
    d_gt = d_test + rng.normal(scale=8, size=SHAPE) * (rng.uniform(size=SHAPE) > 0.3)
    d_est = np.roll(d_gt, 3, axis=1) * (rng.uniform(size=SHAPE) > 0.2)
    np.testing.assert_array_equal(vsd_metrics.depth_im_to_dist_im(d_test, K), jmetrics.depth_im_to_dist_im(d_test, K))
    for mode in ("bop18", "bop19"):
        np.testing.assert_array_equal(vsd_metrics.estimate_visib_mask_gt(d_test, d_gt, 15.0, mode),
                                      jmetrics.estimate_visib_mask_gt(d_test, d_gt, 15.0, mode))
    for cost in ("step", "tlinear"):
        for tau in (5.0, 20.0):
            got = vsd_metrics.vsd_error_from_depths(d_test, d_gt, d_est, K, 15.0, tau, cost)
            assert abs(got - jmetrics.vsd_error_from_depths(d_test, d_gt, d_est, K, 15.0, tau, cost)) <= TOL
            assert 0.0 < got < 1.0
    assert vsd_metrics.vsd_error_from_depths(np.zeros(SHAPE), np.zeros(SHAPE), np.zeros(SHAPE), K) == 1.0
    errors = rng.uniform(0, 1, (17, 5))
    got, want = vsd_metrics.vsd_scores(errors), jmetrics.vsd_scores(errors)
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= TOL, key
    assert vsd.summarize(errors) == got


@pytest.mark.parametrize("mesh", ["box", "random"])
def test_frame_error_and_batch_match(mesh, tmp_path):
    verts, faces = raster.box_mesh((60.0, 80.0, 100.0)) if mesh == "box" else _random_mesh(2)
    cad = str(tmp_path / "cad.obj")
    _write_obj(cad, verts, faces)
    frames = [_frame(tmp_path, cad, verts, faces, s) for s in (0, 1)]
    for frame in frames:
        got = vsd.vsd_frame_error(frame, renderer_backend="numpy")
        want = jvsd.vsd_frame_error(_jax_frame(frame), renderer_backend="numpy")
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert got.shape == (4,) and got[1] > got[0]
    got = vsd.evaluate_vsd_batch(frames, renderer_backend="numpy")
    want = jvsd.evaluate_vsd_batch([_jax_frame(f) for f in frames], renderer_backend="numpy")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if mesh == "box":  # the spawn pool gives the serial result
        np.testing.assert_array_equal(vsd.evaluate_vsd_batch(frames, num_workers=2, renderer_backend="numpy"), got)


def test_gt_pose_scores_zero_on_its_own_render(tmp_path):
    """A test depth that is the GT render itself: VSD of the GT pose is 0."""
    verts, faces = raster.box_mesh((60.0, 80.0, 100.0))
    cad = str(tmp_path / "cad.obj")
    _write_obj(cad, verts, faces)
    gt = _pose(4)
    path = str(tmp_path / "depth.png")
    write_png(path, np.round(raster.rasterize_depth(verts, faces, gt, K, SHAPE) / 0.1).astype(np.uint16))
    frame = vsd.VSDFrame(cad_path=cad, intrinsic=K, depth_path=path, pred_poses=gt[None], gt_pose=gt)
    assert vsd.vsd_frame_error(frame, renderer_backend="numpy").tolist() == [0.0]


def test_build_vsd_frames_matches():
    rng = np.random.default_rng(6)
    templates = Rotation.random(30, random_state=6).as_matrix().astype(np.float32)
    batch = {
        "query_translation": rng.normal(size=(3, 3)).astype(np.float32),
        "query_pose": Rotation.random(3, random_state=7).as_matrix().astype(np.float32),
        "obj_id": np.array([1, 2, 1], np.int32),
        "intrinsic": np.stack([K.astype(np.float32)] * 3),
        "depth_path": np.array(["a.png", "b.png", "c.png"]),
    }
    nearest = rng.integers(0, 30, (3, 5))
    cads = {1: "one.ply", 2: "two.ply"}
    got = vsd.build_vsd_frames(batch, nearest, templates, cads)
    want = jvsd.build_vsd_frames(batch, nearest, templates, cads)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g.cad_path, g.depth_path, g.depth_scale) == (w.cad_path, w.depth_path, w.depth_scale)
        for f in ("intrinsic", "pred_poses", "gt_pose"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_renderer_choice_without_gl(tmp_path, caplog):
    """pyrender and trimesh blocked: "pyrender" raises ImportError as
    JAX's does, "auto" takes the rasteriser and logs it."""
    verts, faces = raster.box_mesh()
    cad = str(tmp_path / "b.obj")
    _write_obj(cad, verts, faces)
    with pytest.raises(ImportError):
        vsd.make_renderer(cad, "pyrender")
    with pytest.raises(ImportError):
        jvsd.make_renderer(cad, "pyrender")
    with caplog.at_level("INFO"):
        r = vsd.make_renderer(cad, "auto")
    assert isinstance(r, raster.NumpyDepthRenderer) and r.backend == "numpy"
    assert "VSD renderer: numpy" in caplog.text
    assert vsd.make_renderer(cad, "numpy").backend == "numpy"
    with pytest.raises(ValueError, match="unknown renderer"):
        vsd.make_renderer(cad, "opengl")


def test_depth_read_without_cv2(tmp_path, monkeypatch):
    depth = np.random.default_rng(8).integers(0, 65535, SHAPE, dtype=np.uint16)
    path = str(tmp_path / "d.png")
    write_png(path, depth, filter_type=4)
    with_cv2 = vsd.read_depth(path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    without = vsd.read_depth(path)
    assert with_cv2.dtype == without.dtype == np.uint16
    np.testing.assert_array_equal(with_cv2, depth)
    np.testing.assert_array_equal(without, depth)
