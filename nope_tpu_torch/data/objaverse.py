"""Objaverse dataset reader, training only (``nope_tpu/data/objaverse.py``).

Rendered Objaverse objects, 10 RGBA images each under
``images/obj_{id:06d}/{k}.png`` with their poses in
``object_poses/obj_{id:06d}.npy``.  Items are query/reference pairs of
one object with their relative rotations, cropped as ShapeNet's (its
intrinsics, a virtual bbox of 1).  The image list is cached in
``img_path.txt`` (the file the JAX reader writes and reads), made of the
objects with exactly 10 renders and shuffled by ``random.Random(seed)``.
The RGBA images are pasted onto black through their alpha with Pillow's
integer blend.
"""

from __future__ import annotations

import glob
import logging
import os.path as osp
import random
from typing import Dict, List

import numpy as np

from nope_tpu_torch.data.bop import paste_on_black
from nope_tpu_torch.data.shapenet import SHAPENET_INTRINSIC, convert_rotation, decode_png
from nope_tpu_torch.geometry.cropping import crop_frame


class ObjaverseDataset:
    IMAGES_PER_OBJECT = 10  # objaverse.py:68-76

    def __init__(
        self,
        root_dir: str,
        img_size: int = 256,
        rot_representation: str = "rotation6d",
        max_objects: int = 1_000_000,
        seed: int = 2023,
    ):
        self.root_dir = root_dir
        self.img_size = img_size
        self.rot_representation = rot_representation
        self._seed = seed
        self._epoch = 0
        self._rng = random.Random(seed)
        self._load_metadata(max_objects)
        logging.info("Objaverse: %d query images", len(self.query_paths))

    def _load_metadata(self, max_objects: int):
        """The objects with exactly 10 renders, cached in ``img_path.txt``
        (``objaverse.py:62-82``)."""
        cache = osp.join(self.root_dir, "img_path.txt")
        if osp.exists(cache):
            with open(cache) as f:
                self.query_paths: List[str] = [line.strip() for line in f if line.strip()]
            return
        paths: List[str] = []
        obj_dirs = sorted(glob.glob(osp.join(self.root_dir, "images", "obj_*")))
        for obj_dir in obj_dirs[:max_objects]:
            imgs = sorted(glob.glob(osp.join(obj_dir, "*.png")))
            if len(imgs) == self.IMAGES_PER_OBJECT:
                paths += imgs
        self._rng.shuffle(paths)
        with open(cache, "w") as f:
            f.write("\n".join(paths) + "\n")
        self.query_paths = paths

    def __len__(self) -> int:
        return len(self.query_paths)

    def open_image(self, path: str) -> np.ndarray:
        """An RGBA render pasted onto black through its alpha, (H, W, 3) uint8."""
        rgba = decode_png(path)
        if rgba.ndim != 3 or rgba.shape[2] != 4:
            raise ValueError(f"{path}: expected an RGBA image, got shape {rgba.shape}")
        return paste_on_black(rgba[..., :3], rgba[..., 3])

    def get_pose(self, path: str) -> np.ndarray:
        obj_name = osp.basename(osp.dirname(path))
        idx = int(osp.basename(path).split(".")[0])
        return np.load(osp.join(self.root_dir, "object_poses", f"{obj_name}.npy"))[idx]

    def sample_reference(self, query_path: str, index: int = 0) -> str:
        """Deterministic, thread-safe draw of another render of the same
        object, per (seed, item index, epoch)."""
        avail = sorted(glob.glob(osp.join(osp.dirname(query_path), "*.png")))
        avail.remove(query_path)
        return random.Random(f"{self._seed}/{index}/{self._epoch}").choice(avail)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        query_path = self.query_paths[index]
        reference_path = self.sample_reference(query_path, index)
        q_pose, r_pose = self.get_pose(query_path), self.get_pose(reference_path)

        def prep(path, pose):
            img = crop_frame(self.open_image(path), None, SHAPENET_INTRINSIC, pose, self.img_size,
                             virtual_bbox_size=1.0)
            return (img.astype(np.float32) / 255.0) * 2.0 - 1.0

        rel = q_pose[:3, :3] @ np.linalg.inv(r_pose)[:3, :3]
        rel_inv = r_pose[:3, :3] @ np.linalg.inv(q_pose)[:3, :3]
        return {
            "query": prep(query_path, q_pose),
            "reference": prep(reference_path, r_pose),
            "relativeR": convert_rotation(rel, self.rot_representation),
            "relativeR_inv": convert_rotation(rel_inv, self.rot_representation),
        }
