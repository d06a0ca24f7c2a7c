"""BOP training and test dataset: T-LESS and the texture-training BOP sets
(``nope_tpu/data/bop.py``), on the host in numpy.

Training items are query/reference pairs of one object in one scene with
their relative rotations; test items add what the VSD evaluation needs:
the 341-template bank's relative rotations (``all_relativeR``), the
template poses, the query's pose without its in-plane rotation and its
translation, the intrinsics, the depth path and the object id.

Filters: training keeps instances with visib_fract >= 0.95 and the first
90% of each object's rows; the upper-hemisphere filter and an optional
BOP'19 (scene, frame) list.  The in-plane rotation is stripped from
every pose by snapping it to the nearest level-2 template
(:class:`~nope_tpu_torch.geometry.so3_grid.NearestTemplateFinder`)
before the relative rotation is taken.

Images decode with Pillow where it is installed, else with the port's
PNG codec (:func:`nope_tpu_torch.data.shapenet.decoder` says which); the
RGB image is pasted onto black through its mask with Pillow's integer
blend, so either route gives the JAX reader's items.
"""

from __future__ import annotations

import json
import logging
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from nope_tpu_torch.data.base_bop import BaseBOP, MetaTable
from nope_tpu_torch.data.shapenet import convert_rotation, decode_png
from nope_tpu_torch.geometry.cropping import crop_frame
from nope_tpu_torch.geometry.so3_grid import NearestTemplateFinder, get_obj_poses_from_template_level
from nope_tpu_torch.geometry.transforms import inverse_transform_numpy


def paste_on_black(rgb: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``Image.new("RGB", size, 0).paste(rgb, mask=mask)`` for an 8-bit
    mask: round(rgb · mask / 255) in integers, as Pillow blends."""
    m = np.asarray(mask, dtype=np.uint16)[..., None]
    return ((np.asarray(rgb, dtype=np.uint16) * m + 127) // 255).astype(np.uint8)


def open_rgb(path: str) -> np.ndarray:
    """A PNG as (H, W, 3) uint8, as ``Image.open(path).convert("RGB")``."""
    try:
        from PIL import Image
    except ImportError:
        arr = decode_png(path)
        if arr.ndim == 2:
            return np.repeat(arr[..., None], 3, axis=-1)
        return np.ascontiguousarray(arr[..., :3])
    return np.asarray(Image.open(path).convert("RGB"))


def open_mask(path: str) -> np.ndarray:
    """An 8-bit mask PNG as (H, W) uint8 (the first channel of a colour one)."""
    arr = decode_png(path)
    if arr.ndim == 3:
        arr = arr[:, :, 0]
    if arr.dtype == bool:  # a 1-bit mask as Pillow reads it
        arr = arr.astype(np.uint8) * 255
    return arr.astype(np.uint8)


class BOPDataset(BaseBOP):
    def __init__(
        self,
        root_dir: str,
        template_dir: Optional[str],
        split: str,
        obj_ids=None,
        img_size: int = 256,
        virtual_bbox_size: Optional[float] = None,
        reset_metaData: bool = False,
        pose_distribution: str = "upper",
        rot_representation: str = "rotation6d",
        isTesting: bool = False,
        bop19_test_list: Optional[str] = None,
        seed: int = 2022,
        **kwargs,
    ):
        super().__init__(root_dir, split)
        self.template_dir = template_dir
        self.rot_representation = rot_representation
        self.pose_distribution = pose_distribution
        self.img_size = img_size
        self.virtual_bbox_size = virtual_bbox_size
        self._seed = seed
        self._epoch = 0

        if isinstance(obj_ids, str):
            obj_ids = [int(x) for x in obj_ids.split(",")]

        self.load_list_scene(split=split)
        self._load_template_poses()
        self.load_cad(cad_name="models_cad" if "tless" in root_dir else "models")
        self.load_metaData(reset_metaData=reset_metaData, mode="query", split=split)
        self.obj_ids = (
            obj_ids if obj_ids is not None else sorted(np.unique(self.metaData.column("obj_id")).tolist())
        )
        self.metaData = self.metaData.with_index()

        self.isTesting = isTesting or split.startswith("test")
        if not self.isTesting and (split.startswith("train") or split.startswith("val")):
            self.metaData = self._subsample(self.metaData, 90)
        else:
            self.metaData = self._subsample(self.metaData, 100)
        self._filter_upper_hemisphere()
        if bop19_test_list is not None:
            self._filter_bop19(bop19_test_list)

        self.nearest_pose_finder = NearestTemplateFinder(
            level_templates=2, pose_distribution="upper", return_inplane=True
        )
        self.neighbor_poses = get_obj_poses_from_template_level(level=2, pose_distribution="all")
        logging.info("BOP %s: %d items, objects %s", split, len(self.metaData), self.obj_ids)

    # -- setup helpers -----------------------------------------------------------

    def _load_template_poses(self):
        if self.template_dir and osp.exists(osp.join(self.template_dir, "obj_poses.npy")):
            self.templates_poses = np.load(osp.join(self.template_dir, "obj_poses.npy"))
        else:
            self.templates_poses = get_obj_poses_from_template_level(2, "all")
        self.testing_indexes, self.testing_templates_poses = get_obj_poses_from_template_level(
            level=2, pose_distribution=self.pose_distribution, return_index=True
        )

    def _subsample(self, table: MetaTable, percentage: int) -> MetaTable:
        """visib_fract >= 0.95 (training), then each object's first
        ``percentage`` % of rows (``bop.py:141-168``)."""
        index = np.arange(len(table))
        obj, visib = table.column("obj_id"), table.column("visib_fract")
        selected: List[int] = []
        for obj_id in self.obj_ids:
            if self.isTesting:
                sel = index[obj == obj_id]
            else:
                sel = index[np.logical_and(obj == obj_id, visib >= 0.95)]
            if percentage > 50:
                sel = sel[: int(percentage / 100 * len(sel))]
            else:
                sel = sel[int((1 - percentage / 100) * len(sel)):]
            selected.extend(sel.tolist())
        out = table.take(selected)
        logging.info("subsampled %d -> %d (%d%%)", len(table), len(out), percentage)
        return out

    def _filter_upper_hemisphere(self):
        if self.pose_distribution != "upper":
            return
        keep = [
            i for i, pose in enumerate(self.metaData.values("pose"))
            if inverse_transform_numpy(np.asarray(pose).reshape(4, 4))[2, 3] >= 0.0
        ]
        before = len(self.metaData)
        self.metaData = self.metaData.take(keep)
        logging.info("upper-hemisphere filter: %d -> %d", before, len(self.metaData))

    def _filter_bop19(self, list_path: str):
        """Keep the (scene, frame) pairs of the BOP'19 test list at
        ``list_path``: ``[[scene, frame], ...]`` or ``{scene: [frame, ...]}``."""
        with open(list_path) as f:
            pairs = json.load(f)
        if isinstance(pairs, dict):
            wanted = {(int(s), int(fr)) for s, frames in pairs.items() for fr in np.atleast_1d(frames)}
        else:
            wanted = {(int(s), int(fr)) for s, fr in pairs}
        scenes, frames = self.metaData.values("scene_id"), self.metaData.values("frame_id")
        keep = [i for i in range(len(self.metaData)) if (int(scenes[i]), int(frames[i])) in wanted]
        before = len(self.metaData)
        self.metaData = self.metaData.take(keep)
        logging.info("BOP19 list filter: %d -> %d", before, len(self.metaData))

    def __len__(self) -> int:
        return len(self.metaData)

    def set_epoch(self, epoch: int) -> None:
        """Advance the deterministic reference-sampling stream."""
        self._epoch = epoch

    # -- item loading ----------------------------------------------------------------

    def _crop(self, img: np.ndarray, pose: np.ndarray, K: np.ndarray, diameter: float):
        """Virtual-bbox crop of 1.2 diameters; BOP poses are in mm, the
        crop takes metres (``bop.py:188-210``)."""
        vbox = diameter * 1.2 if self.virtual_bbox_size is None else self.virtual_bbox_size
        pose_m = np.array(pose, dtype=np.float64)
        pose_m[:3, 3] /= 1000.0
        return crop_frame(img, None, intrinsic=K, openCV_pose=pose_m, image_size=self.img_size,
                          virtual_bbox_size=vbox / 1000.0)

    def _load_image(self, row) -> tuple[np.ndarray, np.ndarray]:
        rgb = paste_on_black(open_rgb(row["rgb_path"]), open_mask(row["mask_path"]))
        K = np.asarray(row["intrinsic"], dtype=np.float64).reshape(3, 3)
        pose = np.asarray(row["pose"], dtype=np.float64).reshape(4, 4)
        diameter = self.cads[int(row["obj_id"])]["model_info"]["diameter"]
        return self._crop(rgb, pose, K, diameter), pose

    def _decompose(self, pose: np.ndarray):
        """Strip the in-plane rotation: the nearest grid template's
        rotation with the pose's translation (``bop.py:234-240``)."""
        idx, inplane = self.nearest_pose_finder.search_nearest_template(pose.reshape(-1, 4, 4))
        updated = np.array(self.neighbor_poses[idx[0]])
        updated[:3, 3] = pose[:3, 3]
        return inplane[0], updated

    def _transform(self, img: np.ndarray) -> np.ndarray:
        return (img.astype(np.float32) / 255.0) * 2.0 - 1.0

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        md = self.metaData
        row = md.row(idx)
        query, query_pose = self._load_image(row)

        # the reference: the same object in the same scene, unoccluded
        obj, scene, visib = md.column("obj_id"), md.column("scene_id"), md.column("visib_fract")
        same = np.logical_and(np.logical_and(obj == row["obj_id"], scene == row["scene_id"]), visib >= 0.95)
        if not np.any(same):
            same = np.logical_and(obj == row["obj_id"], visib >= 0.95)
        candidates = np.flatnonzero(same)
        # deterministic, thread-safe draw per (seed, item index, epoch)
        draw = np.random.default_rng([self._seed, idx, self._epoch]).integers(len(candidates))
        reference, reference_pose = self._load_image(md.row(int(candidates[int(draw)])))

        _, q_wo_inp = self._decompose(query_pose)
        _, r_wo_inp = self._decompose(reference_pose)
        rel = q_wo_inp[:3, :3] @ np.linalg.inv(r_wo_inp)[:3, :3]
        rel_inv = r_wo_inp[:3, :3] @ np.linalg.inv(q_wo_inp)[:3, :3]

        item = {
            "query": self._transform(query),
            "reference": self._transform(reference),
            "relativeR": convert_rotation(rel, self.rot_representation),
            "relativeR_inv": convert_rotation(rel_inv, self.rot_representation),
        }
        if not self.isTesting:
            return item

        # the test extras of the VSD evaluation
        gt_relativeR = item.pop("relativeR")
        ref_inv = np.linalg.inv(r_wo_inp)[:3, :3]
        all_rel = np.stack(
            [
                convert_rotation(self.testing_templates_poses[i][:3, :3] @ ref_inv, self.rot_representation)
                for i in range(len(self.testing_templates_poses))
            ]
        ).astype(np.float32)
        return {
            **item,
            "gt_relativeR": gt_relativeR,
            "all_relativeR": all_rel,
            "query_pose": q_wo_inp[:3, :3].astype(np.float32),
            "query_translation": np.asarray(query_pose[:3, 3], np.float32),
            "template_poses": self.testing_templates_poses[:, :3, :3].astype(np.float32),
            "intrinsic": np.asarray(row["intrinsic"], np.float32).reshape(3, 3),
            "depth_path": str(row["depth_path"]),
            "obj_id": np.asarray(int(row["obj_id"]), np.int32),
        }
