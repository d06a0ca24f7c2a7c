"""ShapeNet dataset reader (``nope_tpu/data/shapenet.py``), numpy on the host.

Directory layout (produced by the offline renderer,
``src/scripts/generate_data.py`` of the reference)::

    root_dir/
      cad_names.txt                      # "synsetid_cadid" per line
      images/obj_{id:06d}/
        query_XXXXXX.png                 # 5 per object, RGBA 512^2
        reference_XXXXXX.png             # 5 per object
        templates_{idx:06d}.png          # 642 per object (level-2 grid)
      object_query_poses/obj_{id:06d}.npy
      object_reference_poses/obj_{id:06d}.npy
      object_template_poses/obj_{id:06d}.npy
      zip/...                            # optional corrupted-PNG rescue

Split semantics (``shapeNet.py:108-154``, seeded with 2023), the JAX
package's to the item: the same root gives the same ``query_paths``
order and the same items.

- ``training``         — 13 train categories, cads[50:] per category
- ``unseen_training``  — same categories, first 50 cads (val split)
- ``<category name>``  — unseen-category test: first 100 cads of that
  category

Items are dicts of numpy arrays, NHWC, images scaled to [-1, 1]; the
device move is the evaluation loop's (``evaluation.geodesic``).  PNGs
are decoded with Pillow where it is installed, else with the port's own
codec (:mod:`nope_tpu_torch.data.png`); :func:`decoder` says which.
"""

from __future__ import annotations

import glob
import io
import logging
import os.path as osp
import random
import zipfile
from typing import Dict, List, Optional, Union

import numpy as np

from nope_tpu_torch.data.categories import SHAPENET_ID2CAT, TRAIN_CATEGORIES, symmetry_class
from nope_tpu_torch.geometry import so3_grid
from nope_tpu_torch.geometry.cropping import crop_frame, crop_homography

SHAPENET_INTRINSIC = np.array(
    [[525, 0, 256], [0, 525, 256], [0, 0, 1]], dtype=np.float64
)  # shapeNet.py:172 / blenderproc.py:104-106

_SPLIT_SEED = 2023  # shapeNet.py:35


def decoder() -> str:
    """"pillow" where Pillow is importable, else "png" (the port's codec)."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return "png"
    return "pillow"


def decode_png(source: Union[str, bytes]) -> np.ndarray:
    """A PNG file (path or bytes) → uint8 array, (H, W) or (H, W, C):
    Pillow where it is installed, as the JAX package reads, else
    :func:`nope_tpu_torch.data.png.read_png` (the same array)."""
    try:
        from PIL import Image
    except ImportError:
        from nope_tpu_torch.data.png import read_png

        return read_png(source)
    img = Image.open(io.BytesIO(source) if isinstance(source, bytes) else source)
    img.load()
    return np.asarray(img)


def _encode_png(path: str, arr: np.ndarray) -> None:
    try:
        from PIL import Image
    except ImportError:
        from nope_tpu_torch.data.png import write_png

        write_png(path, arr)
        return
    Image.fromarray(arr).save(path)


def _rotation6d(mat: np.ndarray) -> np.ndarray:
    """matrix → first-two-rows 6d (host-side, numpy)."""
    return np.asarray(mat[:2, :], dtype=np.float32).reshape(6)


def _quaternion(mat: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(mat).as_quat()  # x, y, z, w
    return np.asarray([q[3], q[0], q[1], q[2]], dtype=np.float32)


def convert_rotation(mat: np.ndarray, representation: str) -> np.ndarray:
    if representation == "rotation6d":
        return _rotation6d(mat)
    if representation == "quaternion":
        return _quaternion(mat)
    if representation == "euler_angles":
        from scipy.spatial.transform import Rotation

        return Rotation.from_matrix(mat).as_euler("XYZ").astype(np.float32)
    raise ValueError(representation)


class ShapeNetDataset:
    """Map-style dataset: ``len()`` + ``[idx] -> dict of numpy arrays``.

    Training items: query, reference, relativeR, relativeR_inv.
    Test items additionally: gt_relativeR, all_relativeR (N, 6),
    gt_templates (N, H, W, 3), query_pose (3, 3),
    template_poses (N, 3, 3), symmetry ().
    """

    def __init__(
        self,
        root_dir: str,
        split: str,
        pose_distribution: str = "upper",
        rot_representation: str = "rotation6d",
        fast_evaluation: bool = True,
        img_size: int = 256,
        level: int = 2,
        seed: int = _SPLIT_SEED,
        load_gt_templates: bool = False,
        wire_dtype: str = "float32",
        cache_crops: bool = False,
    ):
        self.root_dir = root_dir
        self.split = split
        self.pose_distribution = pose_distribution
        self.rot_representation = rot_representation
        self.fast_evaluation = fast_evaluation
        self.img_size = img_size
        self.level = level
        # "uint8": TRAINING items ship raw uint8 crops, normalised on the
        # device; testing-split items keep the float convention (the eval
        # program expects [-1, 1] inputs)
        if wire_dtype not in ("float32", "uint8"):
            raise ValueError(f"wire_dtype={wire_dtype!r}: float32 or uint8")
        self.wire_dtype = wire_dtype
        # the reference loads and crops every template IMAGE per test item
        # (shapeNet.py:287-300) for visualization only: ~26 full PNG
        # decodes and warps per item, so it is opt-in here
        self.load_gt_templates = load_gt_templates
        # opt-in RAM cache of decoded and cropped uint8 views: the crop is
        # a pure function of the path (its pose is the path's npy row), so
        # each view decodes and warps once per process.  Plain dict: safe
        # under the thread loader (GIL-atomic get/set; a race costs one
        # duplicate decode)
        self._crop_cache: Optional[Dict[str, np.ndarray]] = {} if cache_crops else None
        self.is_testing_split = split != "training"
        self._rng = random.Random(seed)
        self._item_seed = seed + 1
        self._epoch = 0

        self._load_testing_template_poses()
        self._load_symmetry_mapping()
        self._load_metadata()
        logging.info("ShapeNet %s: %d query images", split, len(self.query_paths))

    # -- template grid -------------------------------------------------------

    def _load_testing_template_poses(self):
        """Fast eval uses the 26 level-0-in-level-2 indices over the
        level-2 grid (``shapeNet.py:252-263``)."""
        level = 0 if self.fast_evaluation else self.level
        self.testing_indexes, self.testing_templates_poses = so3_grid.get_obj_poses_from_template_level(
            level=level, pose_distribution=self.pose_distribution, return_index=True)
        if self.fast_evaluation and self.level == 2:
            self.testing_indexes = so3_grid.load_index_level0_in_level2(self.pose_distribution)
        # grid indices used for training-template image paths
        self.train_indexes, _ = so3_grid.get_obj_poses_from_template_level(
            level=self.level, pose_distribution=self.pose_distribution, return_index=True)

    # -- metadata ------------------------------------------------------------

    def _load_symmetry_mapping(self):
        with open(osp.join(self.root_dir, "cad_names.txt")) as f:
            self.all_cad_names = [line.strip() for line in f if line.strip()]
        self.obj_name2symmetry = {}
        for idx, cad_name in enumerate(self.all_cad_names):
            cat = SHAPENET_ID2CAT[cad_name.split("_")[0]]
            self.obj_name2symmetry[f"obj_{idx:06d}"] = symmetry_class(cat)

    def _selected_object_ids(self) -> List[int]:
        """Seeded per-category shuffle + split slicing
        (``shapeNet.py:115-140``)."""
        selected_cats = TRAIN_CATEGORIES if self.split in ("training", "unseen_training") else [self.split]
        by_cat: Dict[str, List[int]] = {c: [] for c in selected_cats}
        for obj_id, cad_name in enumerate(self.all_cad_names):
            cat = SHAPENET_ID2CAT[cad_name.split("_")[0]]
            if cat in by_cat:
                by_cat[cat].append(obj_id)
        all_ids: List[int] = []
        for cat in selected_cats:
            self._rng.shuffle(by_cat[cat])
            if self.split == "training":
                all_ids.extend(by_cat[cat][50:])
            elif self.split == "unseen_training":
                all_ids.extend(by_cat[cat][:50])
            else:
                all_ids.extend(by_cat[cat][:100])
        return all_ids

    def _list_images(self, obj_path: str, load_all: bool) -> List[str]:
        imgs = sorted(glob.glob(osp.join(obj_path, "query_*.png")))
        if load_all:  # training uses queries+references+templates alike
            imgs += sorted(glob.glob(osp.join(obj_path, "reference_*.png")))
            imgs += [osp.join(obj_path, f"templates_{idx:06d}.png") for idx in self.train_indexes]
        self._rng.shuffle(imgs)
        return imgs

    def _load_metadata(self):
        load_all = self.split == "training"
        self.query_paths: List[str] = []
        self.query_to_references: Dict[str, List[str]] = {}
        for obj_id in self._selected_object_ids():
            obj_path = osp.join(self.root_dir, "images", f"obj_{obj_id:06d}")
            if not osp.isdir(obj_path):
                logging.warning("missing object dir %s", obj_path)
                continue
            # the reference pool may include references and templates
            # (training), but anchor items are always the query images
            # (shapeNet.py:142-154)
            self.query_to_references[f"obj_{obj_id:06d}"] = self._list_images(obj_path, load_all)
            self.query_paths.extend(sorted(glob.glob(osp.join(obj_path, "query_*.png"))))
        self._rng.shuffle(self.query_paths)

    def __len__(self) -> int:
        return len(self.query_paths)

    # -- image / pose loading --------------------------------------------------

    def _decode_with_rescue(self, path: str) -> np.ndarray:
        """Decode with the corrupted-PNG zip rescue (``shapeNet.py:184-210``):
        a file that fails to decode is read from the object's segment
        archive and written back in place."""
        try:
            return decode_png(path)
        except Exception:  # any decode failure: the reference rescues from the archive
            logging.info("image %s corrupted; trying zip rescue", path)
            obj_id = int(osp.basename(osp.dirname(path))[4:])
            seg = obj_id // 300
            zip_path = osp.join(self.root_dir, f"zip/{seg * 300:06d}_to_{(seg + 1) * 300:06d}.zip")
            with zipfile.ZipFile(zip_path) as archive:
                inner = osp.join(osp.basename(osp.dirname(path)), osp.basename(path))
                arr = decode_png(archive.read(inner))
            _encode_png(path, arr)
            return arr

    def open_image(self, path: str) -> np.ndarray:
        """RGBA → RGB over black background (rescue-protected); RGB as is."""
        arr = self._decode_with_rescue(path)
        if arr.ndim == 3 and arr.shape[2] == 4:
            from nope_tpu_torch import native

            return native.composite_rgba_black(arr)
        if arr.ndim == 3 and arr.shape[2] == 3:
            return arr
        raise ValueError(f"{path}: expected an RGB or RGBA image, got shape {arr.shape}")

    def get_pose(self, path: str) -> np.ndarray:
        obj_name = osp.basename(osp.dirname(path))
        kind = osp.basename(path).split("_")[0]
        if kind == "templates":
            kind = "template"
        idx = int(osp.basename(path).split("_")[1].split(".")[0])
        poses = np.load(osp.join(self.root_dir, f"object_{kind}_poses", obj_name + ".npy"))
        return poses[idx]

    def _crop(self, img: np.ndarray, pose: np.ndarray) -> np.ndarray:
        return crop_frame(img, mask=None, intrinsic=SHAPENET_INTRINSIC, openCV_pose=pose,
                          image_size=self.img_size, virtual_bbox_size=1.0)

    def _cropped(self, path: str, pose: np.ndarray) -> np.ndarray:
        """Decoded-and-cropped uint8 view of ``path`` (see cache_crops)."""
        if self._crop_cache is None:
            return self._crop(self.open_image(path), pose)
        out = self._crop_cache.get(path)
        if out is None:
            out = self._crop(self.open_image(path), pose)
            self._crop_cache[path] = out
        return out

    def _transform(self, img: np.ndarray) -> np.ndarray:
        """uint8 HWC → float32 [-1, 1] NHWC-item (H, W, C)."""
        return (img.astype(np.float32) / 255.0) * 2.0 - 1.0

    def _relative(self, query_pose, ref_pose):
        rel = query_pose[:3, :3] @ np.linalg.inv(ref_pose)[:3, :3]
        rel_inv = ref_pose[:3, :3] @ np.linalg.inv(query_pose)[:3, :3]
        return convert_rotation(rel, self.rot_representation), convert_rotation(rel_inv, self.rot_representation)

    def sample_reference(self, query_path: str, index: int = 0) -> str:
        """Reference-image sampling: a pure function of (seed, item index,
        epoch counter), deterministic and thread-safe."""
        rng = random.Random(f"{self._item_seed}/{index}/{self._epoch}")
        obj_dir = osp.dirname(query_path)
        if not self.is_testing_split:
            return rng.choice(self.query_to_references[osp.basename(obj_dir)])
        return rng.choice(sorted(glob.glob(osp.join(obj_dir, "reference*.png"))))

    def set_epoch(self, epoch: int) -> None:
        """Advance the reference-sampling stream between epochs."""
        self._epoch = epoch

    # -- item assembly -----------------------------------------------------------

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        query_path = self.query_paths[index]
        reference_path = self.sample_reference(query_path, index)
        query_pose = self.get_pose(query_path)
        ref_pose = self.get_pose(reference_path)
        rel, rel_inv = self._relative(query_pose, ref_pose)
        if not self.is_testing_split and self.wire_dtype == "uint8":
            # raw uint8 crops over the wire; normalised on the device
            return {"query": self._cropped(query_path, query_pose),
                    "reference": self._cropped(reference_path, ref_pose),
                    "relativeR": rel, "relativeR_inv": rel_inv}
        query = self._transform(self._cropped(query_path, query_pose))
        reference = self._transform(self._cropped(reference_path, ref_pose))
        if not self.is_testing_split:
            return {"query": query, "reference": reference, "relativeR": rel, "relativeR_inv": rel_inv}

        obj_path = osp.dirname(query_path)
        all_rel = np.stack([
            convert_rotation(self.testing_templates_poses[i][:3, :3] @ np.linalg.inv(ref_pose)[:3, :3],
                             self.rot_representation)
            for i in range(len(self.testing_indexes))
        ])
        item = {
            "query": query,
            "reference": reference,
            "gt_relativeR": rel,
            "all_relativeR": all_rel.astype(np.float32),
            "symmetry": np.asarray(self.obj_name2symmetry[osp.basename(obj_path)], np.float32),
            "query_pose": query_pose[:3, :3].astype(np.float32),
            "template_poses": self.testing_templates_poses[:, :3, :3].astype(np.float32),
        }
        if self.load_gt_templates:
            paths = [osp.join(obj_path, f"templates_{idx:06d}.png") for idx in self.testing_indexes]
            item["gt_templates"] = np.stack([self._transform(self._cropped(p, self.get_pose(p))) for p in paths])
        return item

    # -- native fast path ------------------------------------------------------

    def raw_item(self, index: int) -> Dict[str, np.ndarray]:
        """Raw training item for the native collate path: uncropped RGBA
        images and their crop homographies, so a whole batch is
        composited, warped and normalised in one native call
        (``nope_tpu_torch.native.preprocess_batch``)."""
        query_path = self.query_paths[index]
        reference_path = self.sample_reference(query_path, index)
        q_pose = self.get_pose(query_path)
        r_pose = self.get_pose(reference_path)
        rel, rel_inv = self._relative(q_pose, r_pose)

        def rgba(path):
            arr = self._decode_with_rescue(path)
            if arr.ndim == 2:
                arr = np.stack([arr] * 3 + [np.full_like(arr, 255)], axis=-1)
            elif arr.shape[2] == 3:
                arr = np.concatenate([arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)], axis=-1)
            return arr

        def hom(pose):
            return crop_homography(SHAPENET_INTRINSIC, pose, self.img_size, virtual_bbox_size=1.0)

        return {
            "query_rgba": rgba(query_path),
            "query_M": hom(q_pose),
            "reference_rgba": rgba(reference_path),
            "reference_M": hom(r_pose),
            "relativeR": rel,
            "relativeR_inv": rel_inv,
        }


class NativeCollateView:
    """Wraps a ShapeNetDataset for the native batch-preprocess path:
    items are raw RGBA+homography; pair with
    :func:`nope_tpu_torch.data.pipeline.make_native_collate`."""

    def __init__(self, dataset: ShapeNetDataset):
        if dataset.is_testing_split:
            raise ValueError("native collate path is for training items")
        self.dataset = dataset
        self.img_size = dataset.img_size

    def __len__(self) -> int:
        return len(self.dataset)

    def set_epoch(self, epoch: int) -> None:
        self.dataset.set_epoch(epoch)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.dataset.raw_item(index)
