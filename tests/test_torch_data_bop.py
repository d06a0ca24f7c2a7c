"""The port's BOP and Objaverse readers and their builder branches against
``nope_tpu``'s on the same synthetic roots (``tests.fixtures.make_mini_bop``
and ``make_mini_objaverse``; a 2-scene, 2-object root from
``chip_smoke.write_bop_root``):

- the metadata table's rows and order (a fresh scan, either package's
  ``{split}_metaData.json`` cache read by the other) and its shuffle
  against pandas' ``sample(frac=1, random_state=2021)``;
- the subsample, the upper-hemisphere filter and the BOP'19 list;
- every item equal to JAX's: arrays exactly with Pillow, and with Pillow
  blocked (the port's PNG codec); with Pillow and cv2 blocked the crop
  is the native warp, held to ``tests/test_native.py``'s bound against
  cv2 (>= 99% of pixels within 1 LSB, none over 4), the rest exact;
- a mask with values between 0 and 255;
- the builder's ``objaverse``, ``tless``, ``bop`` and ``bop_texture``
  branches and ``_detect_train_split``'s ``ValueError``;
- ``check_scene``'s images; and every new module importing with jax,
  nope_tpu, pandas, PIL, cv2, trimesh and pyrender blocked.

trimesh and pyrender are blocked throughout: a worker that collected the
reference parity tests may hold stubs of them."""

import dataclasses
import json
import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import chip_smoke
from nope_tpu.configs import load_config as jax_load_config
from nope_tpu.data import builder as jax_builder
from nope_tpu.data.base_bop import BaseBOP as JaxBaseBOP
from nope_tpu.data.bop import BOPDataset as JaxBOP
from nope_tpu.data.objaverse import ObjaverseDataset as JaxObjaverse
from nope_tpu.geometry import so3_grid as jgrid
from nope_tpu_torch.configs import load_config
from nope_tpu_torch.data import builder
from nope_tpu_torch.data.base_bop import BaseBOP, MetaTable
from nope_tpu_torch.data.bop import BOPDataset, paste_on_black
from nope_tpu_torch.data.objaverse import ObjaverseDataset
from nope_tpu_torch.data.png import read_png, write_png
from tests.fixtures import make_mini_bop, make_mini_objaverse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32
FRAMES = 6
# the native warp against cv2 (tests/test_native.py): share within 1 LSB, max LSB
NATIVE_LSB_SHARE, NATIVE_MAX_LSB = 0.99, 4
ROUTES = ["pillow", "png", "png+native"]


@pytest.fixture(autouse=True)
def no_gl(monkeypatch):
    for name in ("pyrender", "trimesh", "nope_tpu.utils.mesh"):
        monkeypatch.setitem(sys.modules, name, None)


def _route(monkeypatch, route):
    if route != "pillow":
        monkeypatch.setitem(sys.modules, "PIL", None)
    if route == "png+native":
        monkeypatch.setitem(sys.modules, "cv2", None)


@pytest.fixture(scope="module")
def mini_bop(tmp_path_factory):
    """make_mini_bop with frame 1 moved below the equator (the
    upper-hemisphere filter drops it) and frame 2's mask graded."""
    root = make_mini_bop(str(tmp_path_factory.mktemp("bop")), n_frames=FRAMES, img_px=64)
    scene = osp.join(root, "test", "000001")
    gt = json.load(open(osp.join(scene, "scene_gt.json")))
    cam = jgrid.load_cam_poses(2)
    lower = jgrid.load_obj_poses(2)[np.flatnonzero(cam[:, 2, 3] < -0.3)[3]]
    gt["1"][0]["cam_R_m2c"] = lower[:3, :3].reshape(-1).tolist()
    json.dump(gt, open(osp.join(scene, "scene_gt.json"), "w"))
    yy, xx = np.mgrid[:64, :64]
    write_png(osp.join(scene, "mask", "000002_000000.png"), ((yy * 4 + xx) % 256).astype(np.uint8))
    os.symlink(osp.join(root, "test"), osp.join(root, "train"))
    return root


@pytest.fixture(scope="module")
def tless_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / "tless")
    chip_smoke.write_bop_root(root, frames=(3, 2), hw=(96, 128), seed=4)
    return root


def _rows_equal(got_rows, jax_frame):
    want = jax_frame.to_dict("records")
    assert len(got_rows) == len(want)
    for g, w in zip(got_rows, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k] == w[k] or (g[k] is None and w[k] is None), (k, g[k], w[k])


class _Scan:
    def __init__(self, cls, root, split):
        self.reader = cls(root, split)
        self.reader.load_list_scene(split=split)

    def load(self, reset):
        return self.reader.load_metaData(reset_metaData=reset, mode="query", split=self.reader.split)


def test_metadata_rows_order_and_cache(tless_root):
    """A fresh scan; then the port reads JAX's cache and JAX the port's."""
    split = "test_primesense"
    jax_md = _Scan(JaxBaseBOP, tless_root, split).load(reset=True)
    port = _Scan(BaseBOP, tless_root, split)
    assert len(jax_md) == 10
    _rows_equal(port.load(reset=True).rows(), jax_md)  # a fresh scan: writes the port's cache
    _rows_equal(port.load(reset=False).rows(), jax_md)
    _rows_equal(port.load(reset=False).rows(), _Scan(JaxBaseBOP, tless_root, split).load(reset=False))
    _Scan(JaxBaseBOP, tless_root, split).load(reset=True)  # JAX's cache again
    _rows_equal(port.load(reset=False).rows(), jax_md)
    table = port.reader.metaData
    assert len({(r["scene_id"], r["frame_id"]) for r in table.rows()}) == 5
    assert sorted(set(table.values("obj_id"))) == [1, 2]


@pytest.mark.parametrize("n", [1, 7, 50, 1000])
def test_shuffle_is_pandas_sample(n):
    import pandas as pd

    frame = pd.DataFrame({"i": np.arange(n)}).sample(frac=1, random_state=2021)
    np.testing.assert_array_equal(np.random.RandomState(2021).permutation(n), frame["i"].to_numpy())
    table = MetaTable({"i": list(range(n))})
    assert table.take(np.random.RandomState(2021).permutation(n)).values("i") == frame["i"].tolist()


def _items_equal(got, want, route):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
        elif route == "png+native" and k in ("query", "reference"):
            lsb = np.abs(np.rint((g - w) * 127.5))
            assert (lsb <= 1).mean() >= NATIVE_LSB_SHARE and lsb.max() <= NATIVE_MAX_LSB, (k, lsb.max())
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("split", ["test", "train"])
def test_bop_items_match(mini_bop, split, route, monkeypatch):
    kw = dict(root_dir=mini_bop, template_dir=None, split=split, obj_ids=[1], img_size=IMG, reset_metaData=True)
    want = JaxBOP(**kw)
    items = {}
    for epoch in (0, 1):
        want.set_epoch(epoch)
        items[epoch] = [want[i] for i in range(len(want))]
    _route(monkeypatch, route)  # the JAX reader needs Pillow
    got = BOPDataset(**kw)
    _rows_equal(got.metaData.rows(), want.metaData)
    # test: every frame but the one below the equator; train: fewer (visib_fract, 90%)
    assert len(got) == len(want) and 0 < len(want) <= FRAMES - 1
    assert (len(want) == FRAMES - 1) == (split == "test")
    for epoch in (0, 1):
        got.set_epoch(epoch)
        for i in range(len(want)):
            _items_equal(got[i], items[epoch][i], route)


def test_graded_mask_paste(mini_bop):
    """Pillow's paste through an 8-bit mask, for every (value, mask) pair,
    and frame 2's graded mask through both readers."""
    from PIL import Image

    x = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 256, axis=1)
    black = Image.new("RGB", (256, 256), (0, 0, 0))
    black.paste(Image.fromarray(np.dstack([x, x.T, 255 - x])), mask=Image.fromarray(x.T))
    np.testing.assert_array_equal(paste_on_black(np.dstack([x, x.T, 255 - x]), x.T), np.asarray(black))
    kw = dict(root_dir=mini_bop, template_dir=None, split="test", obj_ids=[1], img_size=64, reset_metaData=True)
    want, got = JaxBOP(**kw), BOPDataset(**kw)
    row = [i for i, r in enumerate(got.metaData.rows()) if r["frame_id"] == 2][0]
    mask = read_png(got.metaData.row(row)["mask_path"])
    assert 10 < len(np.unique(mask)) and mask.min() == 0 and mask.max() == 255
    _items_equal(got[row], want[row], "pillow")


def test_filters_match(mini_bop, tmp_path):
    kw = dict(root_dir=mini_bop, template_dir=None, split="test", obj_ids="1", img_size=IMG, reset_metaData=True)
    for extra, n in (({"pose_distribution": "all"}, FRAMES), ({}, FRAMES - 1)):
        got, want = BOPDataset(**kw, **extra), JaxBOP(**kw, **extra)
        assert len(got) == len(want) == n
        _rows_equal(got.metaData.rows(), want.metaData)
    pairs = tmp_path / "pairs.json"
    pairs.write_text(json.dumps([[1, 0], [1, 2], [1, 1], [2, 3]]))
    columns = tmp_path / "columns.json"
    columns.write_text(json.dumps({"1": [3, 4, 5]}))
    for lst, n in ((pairs, 2), (columns, 3)):
        got, want = BOPDataset(**kw, bop19_test_list=str(lst)), JaxBOP(**kw, bop19_test_list=str(lst))
        assert len(got) == len(want) == n
        _rows_equal(got.metaData.rows(), want.metaData)
    got = BOPDataset(root_dir=mini_bop, template_dir=None, split="train", img_size=IMG, reset_metaData=True)
    assert got.obj_ids == [1] and got.isTesting is False
    assert BOPDataset(root_dir=mini_bop, template_dir=None, split="train", img_size=IMG, isTesting=True).isTesting


def test_two_scene_items_match(tless_root):
    """The 2-scene, 2-object root: reference draws within a scene, the
    T-LESS CAD folder (``models_cad``), every item."""
    kw = dict(root_dir=tless_root, template_dir=None, split="test_primesense", img_size=IMG, reset_metaData=True)
    want, got = JaxBOP(**kw), BOPDataset(**kw)
    assert got.obj_ids == want.obj_ids == [1, 2] and len(got) == 10
    assert sorted(got.cads) == [1, 2] and got.cads[1]["cad_path"].endswith("models_cad/obj_000001.ply")
    assert got.cads[1]["mesh"] is None
    for i in range(len(want)):
        _items_equal(got[i], want[i], "pillow")


@pytest.mark.parametrize("route", ["pillow", "png"])
def test_objaverse_items_and_cache(tmp_path, route, monkeypatch):
    root = make_mini_objaverse(str(tmp_path / "objaverse"), n_objects=3, img_px=48)
    os.makedirs(osp.join(root, "images", "obj_000009"))  # fewer than 10 renders: not listed
    want = JaxObjaverse(root, img_size=IMG)
    jax_cache = open(osp.join(root, "img_path.txt")).read()
    items = {}
    for epoch in (0, 3):
        want.set_epoch(epoch)
        items[epoch] = {i: want[i] for i in range(0, len(want), 3)}
    _route(monkeypatch, route)  # the JAX reader needs Pillow
    got = ObjaverseDataset(root, img_size=IMG)  # reads JAX's cache
    assert got.query_paths == want.query_paths and len(got) == 30
    os.remove(osp.join(root, "img_path.txt"))
    fresh = ObjaverseDataset(root, img_size=IMG)  # writes its own
    assert fresh.query_paths == want.query_paths
    assert open(osp.join(root, "img_path.txt")).read() == jax_cache
    for epoch in (0, 3):
        got.set_epoch(epoch)
        for i, item in items[epoch].items():
            _items_equal(got[i], item, "pillow")
    rgb = np.zeros((8, 8, 3), np.uint8)
    write_png(str(tmp_path / "rgb.png"), rgb)
    with pytest.raises(ValueError, match="RGBA"):
        got.open_image(str(tmp_path / "rgb.png"))


def _configs(root_bop, root_obj, train_roots, overrides=()):
    ov = [f"data.datasets.tless.root_dir={root_bop}", "data.datasets.tless.img_size=32",
          "data.datasets.tless.split=test", "data.datasets.tless.obj_ids=1,2",
          "data.datasets.objaverse.name=objaverse", f"data.datasets.objaverse.root_dir={root_obj}",
          "data.datasets.objaverse.img_size=32"]
    for name, root in train_roots.items():
        ov += [f"data.datasets.{name}.name=bop", f"data.datasets.{name}.root_dir={root}",
               f"data.datasets.{name}.img_size=32"]
    ov += ["data.datasets.bop_texture.name=bop_texture", "machine.batch_size=2", "machine.num_workers=1", *overrides]
    cfgs = load_config(None, ov), jax_load_config(None, ov)
    for cfg in cfgs:
        cfg.data.datasets["bop_texture"].extra = {"members": list(train_roots)}
    return cfgs


def test_builder_branches(mini_bop, tmp_path):
    obj_root = make_mini_objaverse(str(tmp_path / "objaverse"), n_objects=2, img_px=48)
    members = {}
    for name, seed in (("hb", 1), ("icbin", 2)):
        members[name] = str(tmp_path / name)
        chip_smoke.write_bop_root(members[name], split="train_pbr", frames=(2, 2), hw=(64, 80), seed=seed)
    cfg, jcfg = _configs(mini_bop, obj_root, members)
    for name in ("tless", "objaverse"):
        got = builder.build_dataset(cfg.data.datasets[name])
        want = jax_builder.build_dataset(jcfg.data.datasets[name])
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want) > 0
    bop_cfg = dataclasses.replace(cfg.data.datasets["tless"], name="bop")
    assert isinstance(builder.build_dataset(bop_cfg), BOPDataset)

    group = builder.build_bop_texture_group(cfg, cfg.data.datasets["bop_texture"])
    jgroup = jax_builder.build_bop_texture_group(jcfg, jcfg.data.datasets["bop_texture"])
    assert len(group) == len(jgroup) > 0
    assert [d.split for d in group.datasets] == ["train_pbr", "train_pbr"]
    for i in (0, len(group) - 1):
        _items_equal(group[i], jgroup[i], "pillow")

    cfg, jcfg = _configs(mini_bop, obj_root, members, ["train_data_name=bop_texture,objaverse"])
    loaders = builder.build_train_loaders(cfg)
    jloaders = jax_builder.build_train_loaders(jcfg)
    assert list(loaders) == list(jloaders) == ["bop_texture", "objaverse"]
    for name in loaders:
        assert len(loaders[name]) == len(jloaders[name]) > 0
        batch = next(iter(loaders[name]))
        assert batch["query"].shape == (2, 32, 32, 3) and batch["relativeR"].shape == (2, 6)

    cfg, _ = _configs(mini_bop, obj_root, members, ["train_data_name=tless", "data.datasets.tless.split=",
                                                    f"data.datasets.tless.root_dir={members['hb']}"])
    assert builder.build_train_loaders(cfg)["tless"].dataset.split == "train_pbr"
    cfg, _ = _configs(mini_bop, obj_root, members, ["train_data_name=objaverse", "machine.loader=grain"])
    with pytest.raises(NotImplementedError, match="Not ported"):
        builder.build_train_loaders(cfg)


def test_detect_train_split(tmp_path):
    for splits in ((), ("train_pbr", "val")):
        root = tmp_path / f"r{len(splits)}"
        for s in splits + ("test", "models"):
            (root / s).mkdir(parents=True)
        with pytest.raises(ValueError, match="exactly one train/val split"):
            builder._detect_train_split(str(root))
        with pytest.raises(ValueError, match="exactly one train/val split"):
            jax_builder._detect_train_split(str(root))
    (tmp_path / "one" / "val_real").mkdir(parents=True)
    assert builder._detect_train_split(str(tmp_path / "one")) == "val_real"


def test_check_scene_matches(tmp_path):
    root = make_mini_bop(str(tmp_path / "bop"), n_frames=4, img_px=64, real_cad=True)
    kw = dict(root_dir=root, template_dir=None, split="test", obj_ids=[1], img_size=IMG, reset_metaData=True)
    got = BOPDataset(**kw).check_scene("000001", str(tmp_path / "port"), n_frames=2)
    want = JaxBOP(**kw).check_scene("000001", str(tmp_path / "jax"), n_frames=2)
    assert [osp.basename(p) for p in got] == [osp.basename(p) for p in want] and len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(read_png(g), read_png(w))
    raw = read_png(osp.join(root, "test", "000001", "rgb", "000000.png"))
    assert any((read_png(g)[..., ::-1] != raw).any() for g in got)  # points were drawn
    with pytest.raises(ValueError, match="no metaData rows"):
        BOPDataset(**kw).check_scene("000009", str(tmp_path / "none"))


NEW_MODULES = ["nope_tpu_torch.cli.export", "nope_tpu_torch.cli.test_bop", "nope_tpu_torch.data.base_bop",
               "nope_tpu_torch.data.bop", "nope_tpu_torch.data.objaverse", "nope_tpu_torch.data.builder",
               "nope_tpu_torch.evaluation.raster", "nope_tpu_torch.evaluation.vsd",
               "nope_tpu_torch.evaluation.vsd_metrics", "nope_tpu_torch.geometry.so3_grid",
               "nope_tpu_torch.geometry.transforms", "nope_tpu_torch.utils.mesh",
               "nope_tpu_torch.scripts.find_neighbors", "nope_tpu_torch.data.png"]
BLOCKED = ["jax", "nope_tpu", "pandas", "PIL", "cv2", "trimesh", "pyrender"]


def test_new_modules_import_without_optional_packages(tmp_path):
    """Every new module imports with jax, nope_tpu, pandas, PIL, cv2,
    trimesh and pyrender blocked; a BOP test item and an
    Objaverse item then read through the PNG codec and the native warp;
    none of the blocked packages was imported."""
    bop_root = make_mini_bop(str(tmp_path / "bop"), n_frames=2, img_px=48)
    obj_root = make_mini_objaverse(str(tmp_path / "objaverse"), n_objects=1, img_px=48)
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        for name in {NEW_MODULES!r}:
            importlib.import_module(name)
        from nope_tpu_torch.data.bop import BOPDataset
        from nope_tpu_torch.data.objaverse import ObjaverseDataset
        item = BOPDataset({bop_root!r}, None, "test", img_size=16, reset_metaData=True)[0]
        assert item["query"].shape == (16, 16, 3) and item["all_relativeR"].shape == (341, 6)
        assert ObjaverseDataset({obj_root!r}, img_size=16)[0]["relativeR"].shape == (6,)
        loaded = {{m.split(".")[0] for m, v in sys.modules.items() if v is not None}}
        assert not loaded & set({BLOCKED!r}), loaded & set({BLOCKED!r})
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
