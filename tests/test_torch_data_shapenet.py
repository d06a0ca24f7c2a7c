"""The port's ShapeNet reader (``nope_tpu_torch.data.shapenet``) against
``nope_tpu.data.shapenet`` on the synthetic roots of ``tests/fixtures``:
split selection, ``query_paths`` order, reference pools, items (test and
training schemas, float32 and uint8 wires, ``cache_crops``,
``load_gt_templates``), ``raw_item`` and the native collate, rotation
representations, and the corrupted-PNG zip rescue.  Both sides decode
with Pillow and crop with cv2 here, so items are compared bitwise."""

import os
import shutil
import zipfile

import numpy as np
import pytest

from nope_tpu.data import pipeline as jpipeline
from nope_tpu.data import shapenet as jshapenet
from nope_tpu.geometry import so3_grid
from nope_tpu_torch.data import categories, pipeline, shapenet
from tests.fixtures import make_mini_shapenet, make_procedural_shapenet, make_shapenet_object

IMG = 32


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    return make_mini_shapenet(str(tmp_path_factory.mktemp("shapenet")), objects_per_cat=2)


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """52 airplanes, of which the two that the seeded shuffle puts in the
    training slice (cads[50:]) exist, with the whole level-2 template set."""
    root = str(tmp_path_factory.mktemp("train_root"))
    with open(os.path.join(root, "cad_names.txt"), "w") as f:
        f.write("".join(f"{categories.SHAPENET_CAT2ID['airplane']}_c{j}\n" for j in range(52)))

    class Probe(jshapenet.ShapeNetDataset):
        def _load_metadata(self):
            self.selected = self._selected_object_ids()
            self.query_paths = []

    selected = Probe(root, split="training").selected
    assert len(selected) == 2
    train_idx, _ = so3_grid.get_obj_poses_from_template_level(2, "upper", return_index=True)
    rng = np.random.default_rng(1)
    for obj_id in selected:
        make_shapenet_object(root, obj_id, rng, train_idx, img_px=64)
    return root


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _pair(root, split, **kw):
    got = shapenet.ShapeNetDataset(root, split, img_size=IMG, **kw)
    want = jshapenet.ShapeNetDataset(root, split, img_size=IMG, **kw)
    assert got.query_paths == want.query_paths
    assert got.query_to_references == want.query_to_references
    return got, want


def test_categories_are_the_jax_tables():
    from nope_tpu.data import categories as jcat

    assert categories.SHAPENET_ID2CAT == jcat.SHAPENET_ID2CAT
    assert categories.SHAPENET_CAT2ID == jcat.SHAPENET_CAT2ID
    assert categories.TRAIN_CATEGORIES == jcat.TRAIN_CATEGORIES
    assert categories.TEST_CATEGORIES == jcat.TEST_CATEGORIES
    assert categories.CIRCULAR_SYMMETRY_CATEGORIES == jcat.CIRCULAR_SYMMETRY_CATEGORIES
    for cat in categories.SHAPENET_CAT2ID:
        assert categories.symmetry_class(cat) == jcat.symmetry_class(cat)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("split", ["bottle", "airplane", "unseen_training"])
def test_test_splits_match_jax(mini_root, split, fast):
    got, want = _pair(mini_root, split, fast_evaluation=fast, load_gt_templates=fast)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        _assert_items_equal(got[i], want[i])
    assert got[0]["all_relativeR"].shape == (26 if fast else 341, 6)
    if fast:
        assert got[0]["gt_templates"].shape == (26, IMG, IMG, 3)


@pytest.mark.parametrize("wire_dtype", ["float32", "uint8"])
def test_training_split_matches_jax(train_root, wire_dtype):
    got, want = _pair(train_root, "training", wire_dtype=wire_dtype)
    assert len(want) == 6
    for epoch in (0, 3):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(want)):
            assert got.sample_reference(got.query_paths[i], i) == want.sample_reference(want.query_paths[i], i)
            _assert_items_equal(got[i], want[i])
    assert got[0]["query"].dtype == (np.uint8 if wire_dtype == "uint8" else np.float32)
    with pytest.raises(ValueError, match="wire_dtype"):
        shapenet.ShapeNetDataset(train_root, "training", wire_dtype="float16")


def test_cache_crops_matches_jax_and_decodes_once(mini_root):
    got, want = _pair(mini_root, "unseen_training", cache_crops=True)
    plain = shapenet.ShapeNetDataset(mini_root, "unseen_training", img_size=IMG)
    for i in range(len(want)):
        _assert_items_equal(got[i], want[i])
        _assert_items_equal(got[i], plain[i])
    calls = []
    orig = got.open_image
    got.open_image = lambda p: (calls.append(p), orig(p))[1]
    got[0]
    assert calls == [] and len(got._crop_cache) > 0 and plain._crop_cache is None


def test_raw_items_and_native_collate_match_jax(train_root):
    """raw_item bitwise; the native collate's batch within a few float32
    ulps (the JAX package's prebuilt library uses fused multiply-adds,
    tests/test_torch_cropping.py) and within the per-item path's bound
    of the fused preprocess (tests/test_data_shapenet.py)."""
    got, want = _pair(train_root, "training")
    for i in (0, 3):
        _assert_items_equal(got.raw_item(i), want.raw_item(i))
    view, jview = shapenet.NativeCollateView(got), jshapenet.NativeCollateView(want)
    assert len(view) == len(jview) and view.img_size == IMG
    items = [view[i] for i in range(3)]
    batch = pipeline.make_native_collate(IMG)(items)
    jbatch = jpipeline.make_native_collate(IMG)([jview[i] for i in range(3)])
    assert set(batch) == set(jbatch) == {"query", "reference", "relativeR", "relativeR_inv"}
    for k in batch:
        np.testing.assert_allclose(batch[k], jbatch[k], rtol=0, atol=6e-7, err_msg=k)
    for i in range(3):
        np.testing.assert_allclose(batch["query"][i], got[i]["query"], atol=0.03)
    with pytest.raises(ValueError, match="training items"):
        shapenet.NativeCollateView(shapenet.ShapeNetDataset(train_root, "airplane", img_size=IMG))


def test_procedural_root_matches_jax(tmp_path):
    root = make_procedural_shapenet(str(tmp_path / "p"), objects_per_cat=1, img_px=128)
    got, want = _pair(root, "bottle", load_gt_templates=True)
    for i in range(len(want)):
        _assert_items_equal(got[i], want[i])
    assert float(got[0]["symmetry"]) == 2.0


@pytest.mark.parametrize("representation", ["rotation6d", "quaternion", "euler_angles"])
def test_convert_rotation_matches_jax(representation):
    poses = so3_grid.load_obj_poses(2)[::37, :3, :3]
    for mat in poses:
        np.testing.assert_allclose(shapenet.convert_rotation(mat, representation),
                                   jshapenet.convert_rotation(mat, representation), atol=1e-6)
    with pytest.raises(ValueError):
        shapenet.convert_rotation(poses[0], "axis_angle")


def test_zip_rescue_matches_jax(mini_root, tmp_path):
    """A corrupted query is read from its segment archive
    (zip/000000_to_000300.zip) and written back, by both readers."""
    roots = {}
    for name in ("port", "jax"):
        root = roots[name] = str(tmp_path / name)
        shutil.copytree(mini_root, root)
        good = os.path.join(root, "images", "obj_000000", "query_000001.png")
        os.makedirs(os.path.join(root, "zip"))
        with zipfile.ZipFile(os.path.join(root, "zip", "000000_to_000300.zip"), "w") as archive:
            archive.write(good, "obj_000000/query_000001.png")
        with open(good, "r+b") as f:  # truncate the file on disk to half its bytes
            f.truncate(os.path.getsize(good) // 2)
    got = shapenet.ShapeNetDataset(roots["port"], "bottle", img_size=IMG)
    want = jshapenet.ShapeNetDataset(roots["jax"], "bottle", img_size=IMG)
    assert [os.path.relpath(p, roots["port"]) for p in got.query_paths] == \
        [os.path.relpath(p, roots["jax"]) for p in want.query_paths]
    bad = next(i for i, p in enumerate(got.query_paths) if p.endswith("obj_000000/query_000001.png"))
    _assert_items_equal(got[bad], want[bad])
    rewritten = shapenet.decode_png(got.query_paths[bad])
    np.testing.assert_array_equal(rewritten, shapenet.decode_png(
        os.path.join(mini_root, "images", "obj_000000", "query_000001.png")))
