"""The port's offline data tools (``nope_tpu_torch.scripts``:
``generate_data``, ``generate_objaverse``, ``blender_objaverse``,
``download_datasets`` and the ``blenderproc_render.py`` copy) against
``nope_tpu.scripts`` on the same inputs: the JAX package's own tests of
them rerun on the port, and the files both packages write compared byte
for byte."""

import ast
import json
import logging
import os.path as osp
import sys
import zipfile

import numpy as np
import pytest
import yaml

from nope_tpu.scripts import blender_objaverse as jblender
from nope_tpu.scripts import generate_data as jgen
from nope_tpu.scripts import generate_objaverse as jobjaverse
from nope_tpu_torch.scripts import blender_objaverse, download_datasets, generate_data, generate_objaverse
from nope_tpu_torch.utils import inout

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


# -- generate_data -------------------------------------------------------------------


def test_sample_camera_poses_upper_hemisphere():
    poses = generate_data.sample_camera_poses(np.random.default_rng(0), 64, radius=1.2)
    assert poses.shape == (64, 4, 4)
    np.testing.assert_array_equal(poses, jgen.sample_camera_poses(np.random.default_rng(0), 64, radius=1.2))
    # cameras on the upper hemisphere, 1.2 away: the inverse pose's translation
    from nope_tpu_torch.geometry.transforms import inverse_transform_numpy

    for p in poses[:8]:
        cam = inverse_transform_numpy(p)
        assert cam[2, 3] >= -1e-6
        np.testing.assert_allclose(np.linalg.norm(cam[:3, 3]), 1.2, atol=1e-5)
    rots = poses[:, :3, :3]
    np.testing.assert_allclose(np.einsum("bij,bkj->bik", rots, rots), np.tile(np.eye(3), (64, 1, 1)), atol=1e-5)


def _generation_inputs(save_dir, n=3):
    save_dir.mkdir(parents=True, exist_ok=True)
    names = [f"02691156_cad{i}" for i in range(n)]
    inout.write_txt(str(save_dir / "cad_paths.txt"), [f"/fake/cad{i}.obj" for i in range(n)])
    inout.write_txt(str(save_dir / "cad_names.txt"), names)
    inout.save_json(str(save_dir / "obj_diameter.json"), {m: 0.8 + 0.1 * i for i, m in enumerate(names)})


def test_generate_object_poses_and_dry_run(tmp_path):
    """JAX's dry-run test on the port; the pose files and the failure list
    are byte-equal to JAX's for the same save_dir contents."""
    for sub in ("port", "jax"):
        _generation_inputs(tmp_path / sub)
    generate_data.run_generate(str(tmp_path / "port"), num_workers=1, dry_run=True)
    jgen.run_generate(str(tmp_path / "jax"), num_workers=1, dry_run=True)
    q = np.load(tmp_path / "port" / "object_query_poses" / "obj_000000.npy")
    r = np.load(tmp_path / "port" / "object_reference_poses" / "obj_000000.npy")
    t = np.load(tmp_path / "port" / "object_template_poses" / "obj_000000.npy")
    assert q.shape == (5, 4, 4) and r.shape == (5, 4, 4) and t.shape == (642, 4, 4)
    np.testing.assert_allclose(np.linalg.norm(t[:, :3, 3], axis=1), 1.2 * 0.8, atol=1e-5)
    assert (tmp_path / "port" / "failed_renderings_0_3.txt").read_text() == ""
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want and len([k for k in got if k.endswith(".npy")]) == 9
    # the default render script is the port's own copy, beside generate_data.py
    assert osp.isfile(osp.join(osp.dirname(generate_data.__file__), "blenderproc_render.py"))


def test_generate_data_main_range_and_arguments(tmp_path):
    for sub in ("port", "jax"):
        _generation_inputs(tmp_path / sub, n=4)
    argv = ["--step", "generate_poses_and_images", "--num_workers", "2", "--start", "1", "--end", "9", "--dry-run"]
    generate_data.main(argv + ["--save_dir", str(tmp_path / "port")])
    saved = sys.argv
    sys.argv = ["generate_data"] + argv + ["--save_dir", str(tmp_path / "jax")]
    try:
        jgen.main()
    finally:
        sys.argv = saved
    got = _files(tmp_path / "port")
    assert got == _files(tmp_path / "jax") and "failed_renderings_1_4.txt" in got
    assert not (tmp_path / "port" / "object_query_poses" / "obj_000000.npy").exists()
    with pytest.raises(SystemExit):
        generate_data.main(["--step", "select_cad", "--save_dir", str(tmp_path)])


def test_call_blenderproc_runs_the_renderer_and_counts_its_images(tmp_path, monkeypatch):
    """The render subprocess really runs (the reference comments it out):
    success is exit 0 and 652 PNGs; anything else is a failure."""
    import subprocess

    made = []

    def fake_run(command, capture_output, text):
        made.append(command)
        out_dir = command[-1]
        for i in range(n_images):
            open(osp.join(out_dir, f"templates_{i:06d}.png"), "wb").close()
        return subprocess.CompletedProcess(command, returncode, "", "boom")

    monkeypatch.setattr(generate_data.subprocess, "run", fake_run)
    for n_images, returncode, ok in ((652, 0, True), (651, 0, False), (652, 1, False)):
        save = tmp_path / f"{n_images}_{returncode}"
        assert generate_data.call_blenderproc(0, ["/cad.obj"], str(save), "render.py") is ok
    assert made[0] == ["blenderproc", "run", "render.py", "/cad.obj",
                       str(tmp_path / "652_0" / "object_query_poses" / "obj_000000.npy"),
                       str(tmp_path / "652_0" / "object_reference_poses" / "obj_000000.npy"),
                       str(tmp_path / "652_0" / "object_template_poses" / "obj_000000.npy"),
                       str(tmp_path / "652_0" / "images" / "obj_000000")]


_STUB_TRIMESH = '''
"""A trimesh stand-in: ``load`` reads an OBJ's vertices; a file whose name holds "broken" fails."""
import numpy as np


class Scene:
    pass


class Trimesh:
    def __init__(self, vertices):
        self.vertices = np.asarray(vertices, dtype=np.float64)

    @property
    def bounds(self):
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    @property
    def extents(self):
        return self.bounds[1] - self.bounds[0]


def load(path):
    if "broken" in path:
        raise ValueError("cannot parse " + path)
    with open(path) as f:
        return Trimesh([[float(x) for x in line.split()[1:4]] for line in f if line.startswith("v ")])
'''


def _shapenet_cads(root):
    """A ShapeNet-layout tree: textured CADs, one without textures, one
    without a model, one whose mesh fails to load."""
    rng = np.random.default_rng(7)
    cads = {"02691156": ["a1", "a2", "notex"], "02958343": ["c1", "broken", "nomodel"]}
    for synset, ids in cads.items():
        for cad in ids:
            d = root / synset / cad
            (d / "images").mkdir(parents=True)
            if cad != "nomodel":
                (d / "models").mkdir()
                verts = rng.uniform(-0.5, 0.5, (12, 3)) * rng.uniform(0.5, 1.5, 3)
                (d / "models" / "model_normalized.obj").write_text("".join(f"v {x} {y} {z}\n" for x, y, z in verts))
            if cad != "notex":
                (d / "images" / "texture0.jpg").write_bytes(b"jpg")
    return cads


def test_select_cad_with_texture_matches_under_a_stub_trimesh(tmp_path, monkeypatch):
    """``select_cad_with_texture`` and ``run_select_cad`` (spawn workers for
    the port, fork for JAX) agree with JAX's under the same stub
    ``trimesh`` module, found on ``sys.path`` by the workers too."""
    stub_dir = tmp_path / "stub"
    stub_dir.mkdir()
    (stub_dir / "trimesh.py").write_text(_STUB_TRIMESH)
    monkeypatch.syspath_prepend(str(stub_dir))
    for name in ("trimesh", "nope_tpu.utils.mesh", "nope_tpu_torch.utils.mesh"):
        # recorded first, so teardown also drops what the test imports under the stub
        monkeypatch.setitem(sys.modules, name, None)
        monkeypatch.delitem(sys.modules, name)
    cads = _shapenet_cads(tmp_path / "ShapeNetCore")
    for synset, ids in cads.items():
        for cad in ids:
            d = str(tmp_path / "ShapeNetCore" / synset / cad)
            got, want = generate_data.select_cad_with_texture(d), jgen.select_cad_with_texture(d)
            assert got == want
            assert (got is None) == (cad in ("notex", "broken", "nomodel"))
    generate_data.run_select_cad(str(tmp_path / "ShapeNetCore"), str(tmp_path / "port"), num_workers=2)
    jgen.run_select_cad(str(tmp_path / "ShapeNetCore"), str(tmp_path / "jax"), num_workers=2)
    got = _files(tmp_path / "port")
    assert got == _files(tmp_path / "jax")
    assert got["cad_names.txt"] == b"02691156_a1\n02691156_a2\n02958343_c1\n"
    assert all(d > 0 for d in json.loads(got["obj_diameter.json"]).values())


def test_select_cad_without_trimesh_selects_nothing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "trimesh", None)
    monkeypatch.delitem(sys.modules, "nope_tpu_torch.utils.mesh", raising=False)
    _shapenet_cads(tmp_path)
    assert generate_data.select_cad_with_texture(str(tmp_path / "02691156" / "a1")) is None


# -- generate_objaverse ----------------------------------------------------------------


def test_generate_objaverse_dry_run_matches(tmp_path, caplog):
    annotations = {f"uid{i}": {"categories": [f"cat{i % 3}"] * (1 + (i % 4 == 0))} for i in range(9)}
    annotations["none"] = {}
    paths = {u: f"/objaverse/{u}.glb" for u in annotations}
    for sub in ("port", "jax"):
        (tmp_path / sub).mkdir()
    inout.save_json(str(tmp_path / "annotations.json"), annotations)
    inout.save_json(str(tmp_path / "object_paths.json"), paths)
    args = (str(tmp_path / "annotations.json"), str(tmp_path / "object_paths.json"))
    with caplog.at_level(logging.INFO):
        generate_objaverse.run(str(tmp_path / "port" / "out"), *args, dry_run=True, max_objects=5)
    jobjaverse.run(str(tmp_path / "jax" / "out"), *args, dry_run=True, max_objects=5)
    got = _files(tmp_path / "port")
    assert got == _files(tmp_path / "jax")
    uids = got["out/filtered_uids.txt"].decode().split()
    assert uids == generate_objaverse.filter_single_category(annotations)[:5] == ["uid1", "uid2", "uid3", "uid5", "uid6"]
    poses = np.load(tmp_path / "port" / "out" / "object_poses" / "obj_000004.npy")
    assert poses.shape == (10, 4, 4)
    script = osp.join(REPO, "nope_tpu_torch", "scripts", "blenderproc_render.py")
    assert sum(f"DRY RUN: blenderproc run {script}" in r.message for r in caplog.records) == 5
    generate_objaverse.main(["--save_dir", str(tmp_path / "main"), "--annotations", args[0], "--object_paths", args[1],
                             "--max_objects", "2", "--dry-run"])
    assert (tmp_path / "main" / "filtered_uids.txt").read_text() == "uid1\nuid2\n"


# -- blenderproc_render.py, blender_objaverse --------------------------------------------


def test_blenderproc_render_is_the_jax_script():
    """The port's render script runs inside BlenderProc and is never
    imported: it compiles, and below its docstring it is JAX's."""
    def body(path):
        src = open(path).read()
        tree = ast.parse(src)
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    port = osp.join(REPO, "nope_tpu_torch", "scripts", "blenderproc_render.py")
    assert body(port) == body(osp.join(REPO, "nope_tpu", "scripts", "blenderproc_render.py"))
    compile(open(port).read(), port, "exec")


def test_blender_objaverse_pose_math():
    """JAX's test of the raw-Blender renderer's numpy math on the port, and
    every function against JAX's on the same poses."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(3)
    for _ in range(5):
        pose = np.eye(4)
        pose[:3, :3] = Rotation.random(random_state=rng).as_matrix()
        pose[:3, 3] = rng.normal(size=3)
        inv = blender_objaverse.inverse_transform(pose)
        np.testing.assert_allclose(inv @ pose, np.eye(4), atol=1e-12)
        np.testing.assert_array_equal(inv, jblender.inverse_transform(pose))
        # the reference's step sequence (blender_objaverse.py:24-54)
        C = np.diag([1.0, -1.0, -1.0])
        cv_w2c_rot = pose[:3, :3].T
        b_w2c_rot = C @ cv_w2c_rot
        b_translation = C @ (-cv_w2c_rot @ pose[:3, 3])
        want = np.eye(4)
        want[:3, :3] = b_w2c_rot.T
        want[:3, 3] = -b_w2c_rot.T @ b_translation
        got = blender_objaverse.opencv_cam2world_to_blender(pose)
        np.testing.assert_allclose(got, want, atol=1e-12)
        np.testing.assert_array_equal(got, jblender.opencv_cam2world_to_blender(pose))
    obj_poses = np.stack([pose, inv])
    blender = blender_objaverse.object_poses_to_blender_cam(obj_poses)
    np.testing.assert_array_equal(blender, jblender.object_poses_to_blender_cam(obj_poses))
    np.testing.assert_allclose(blender[0][:3, 3], -pose[:3, :3].T @ pose[:3, 3], atol=1e-12)
    assert blender_objaverse.kinect_focal_px(512) == 525.0 == jblender.kinect_focal_px(512)
    assert blender_objaverse.light_rig_positions(2.0) == jblender.light_rig_positions(2.0)
    assert len(blender_objaverse.light_rig_positions()) == 8


def test_blender_interface_needs_bpy(monkeypatch):
    monkeypatch.setitem(sys.modules, "bpy", None)
    with pytest.raises(ImportError):
        blender_objaverse.BlenderInterface()
    with pytest.raises(ValueError, match="unknown engine"):
        monkeypatch.setitem(sys.modules, "bpy", type(sys)("bpy"))
        blender_objaverse.BlenderInterface(name_engine="OPTIX")


# -- download_datasets ---------------------------------------------------------------------


def _archives(tmp_path):
    archives = tmp_path / "server"
    archives.mkdir()
    data_zip, cad_zip = archives / "mini_train.zip", archives / "mini_models.zip"
    with zipfile.ZipFile(data_zip, "w") as zf:
        zf.writestr("train/000001/rgb/000000.png", b"png")
    with zipfile.ZipFile(cad_zip, "w") as zf:
        zf.writestr("models/obj_000001.ply", b"ply")
    return archives, data_zip, cad_zip


def test_download_datasets_tool(tmp_path, caplog):
    """JAX's test on the port: the ``source:`` blocks, read through the
    port's ``load_config``, download (``file://`` here) and extract into
    root_dir; re-runs are idempotent; non-direct sources are reported."""
    _, data_zip, cad_zip = _archives(tmp_path)
    root = tmp_path / "datasets"
    cfg = {"data": {"datasets": {
        "mini": {"name": "bop", "root_dir": str(root / "mini"),
                 "source": {"url": data_zip.as_uri(), "cad_url": cad_zip.as_uri(), "http": True,
                            "unzip_mode": "unzip"}},
        "manual": {"name": "bop", "root_dir": str(root / "manual"),
                   "source": {"url": "https://example.com/nope.zip", "http": False}},
    }}}
    cfg_path = tmp_path / "dl.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    with caplog.at_level(logging.INFO):
        rc = download_datasets.main(["--config", str(cfg_path)])
    assert rc == 1  # the manual dataset cannot be fetched
    assert (root / "mini" / "train" / "000001" / "rgb" / "000000.png").read_bytes() == b"png"
    assert (root / "mini" / "models" / "obj_000001.ply").exists()
    assert not list((root / "mini").glob("*.zip"))
    assert any("manually" in r.message for r in caplog.records)
    with caplog.at_level(logging.INFO):
        assert download_datasets.main(["--config", str(cfg_path), "--only", "mini"]) == 0
    assert any("already populated" in r.message for r in caplog.records)


def test_download_datasets_resume_and_errors(tmp_path, caplog):
    archives, data_zip, cad_zip = _archives(tmp_path)
    root = tmp_path / "datasets"
    cfg = {"data": {"datasets": {
        "broken": {"name": "bop", "root_dir": str(root / "broken"),
                   "source": {"url": (archives / "missing.zip").as_uri(), "http": True}},
        "mini": {"name": "bop", "root_dir": str(root / "mini"),
                 "source": {"url": data_zip.as_uri(), "cad_url": cad_zip.as_uri(), "http": True,
                            "unzip_mode": "unzip"}},
    }}}
    cfg_path = tmp_path / "dl.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    mini = root / "mini"
    mini.mkdir(parents=True)
    with zipfile.ZipFile(data_zip) as zf:
        zf.extractall(mini)
    (mini / download_datasets.STATE_FILE).write_text('{"done": ["url"]}')
    with caplog.at_level(logging.INFO):
        assert download_datasets.main(["--config", str(cfg_path)]) == 1
    assert any("fetch failed" in r.message for r in caplog.records)
    assert any("resuming" in r.message for r in caplog.records)
    assert (mini / "models" / "obj_000001.ply").exists() and not (mini / download_datasets.STATE_FILE).exists()
    with pytest.raises(SystemExit):
        download_datasets.main(["--config", str(cfg_path), "--only", "nope_such_dataset"])


def test_extract_archive_dispatches_on_extension_and_refuses_traversal(tmp_path):
    import tarfile

    payload = tmp_path / "payload.txt"
    payload.write_text("hello")
    tgz = tmp_path / "data.tar.gz"
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(payload, arcname="sub/payload.txt")
    download_datasets.extract_archive(str(tgz), str(tmp_path / "out"), unzip_mode="unzip")
    assert (tmp_path / "out" / "sub" / "payload.txt").read_text() == "hello"
    evil = tmp_path / "evil.zip"
    with zipfile.ZipFile(evil, "w") as zf:
        zf.writestr("../escape.txt", b"x")
    with pytest.raises(ValueError, match="unsafe path"):
        download_datasets.extract_archive(str(evil), str(tmp_path / "out2"))
    assert not (tmp_path / "escape.txt").exists()


def test_fetch_dataset_without_source_and_hand_populated(tmp_path):
    from nope_tpu_torch.configs.config import DatasetConfig

    assert download_datasets.fetch_dataset("none", DatasetConfig(root_dir=str(tmp_path / "absent"))) is False
    (tmp_path / "hand").mkdir()
    (tmp_path / "hand" / "x").write_text("x")
    cfg = DatasetConfig(root_dir=str(tmp_path / "hand"), source={"url": "file:///nope.zip"})
    assert download_datasets.fetch_dataset("hand", cfg) is True  # populated by hand: left alone
    assert sorted(p.name for p in (tmp_path / "hand").iterdir()) == ["x"]
