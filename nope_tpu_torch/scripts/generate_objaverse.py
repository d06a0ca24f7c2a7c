"""Objaverse rendering-dataset generator
(``nope_tpu/scripts/generate_objaverse.py``).

The reference's ``src/scripts/generate_objaverse.py`` +
``src/poses/blender_objaverse.py``: filter Objaverse to single-category
objects, sample 10 random upper-hemisphere poses per object, and render
via Blender.  Uses the same pose-sampling machinery as the ShapeNet
generator; rendering reuses ``blenderproc_render.py`` (the reference's raw
``BlenderInterface`` is a Blender-API detail, not a capability).

Usage::

    python -m nope_tpu_torch.scripts.generate_objaverse --save_dir ... \
        --annotations annotations.json --object_paths object_paths.json \
        [--dry-run]
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import subprocess
from typing import Dict, List

import numpy as np

from nope_tpu_torch.scripts.generate_data import sample_camera_poses
from nope_tpu_torch.utils.inout import load_json, save_json, write_txt

IMAGES_PER_OBJECT = 10


def filter_single_category(annotations: Dict[str, dict]) -> List[str]:
    """Keep objects annotated with exactly one category
    (``generate_objaverse.py`` filter semantics)."""
    uids = []
    for uid, ann in annotations.items():
        cats = ann.get("categories", [])
        if len(cats) == 1:
            uids.append(uid)
    return uids


def run(save_dir: str, annotations_path: str, object_paths_path: str,
        blender_script: str | None = None, dry_run: bool = False,
        max_objects: int | None = None, seed: int = 2022) -> None:
    annotations = load_json(annotations_path)
    object_paths = load_json(object_paths_path)
    uids = filter_single_category(annotations)
    if max_objects:
        uids = uids[:max_objects]
    os.makedirs(save_dir, exist_ok=True)
    write_txt(osp.join(save_dir, "filtered_uids.txt"), uids)
    save_json(osp.join(save_dir, "object_paths.json"),
              {u: object_paths[u] for u in uids if u in object_paths})

    rng = np.random.default_rng(seed)
    pose_dir = osp.join(save_dir, "object_poses")
    os.makedirs(pose_dir, exist_ok=True)
    script = blender_script or osp.join(osp.dirname(osp.abspath(__file__)), "blenderproc_render.py")
    failed = []
    for obj_id, uid in enumerate(uids):
        name = f"obj_{obj_id:06d}"
        poses = sample_camera_poses(rng, IMAGES_PER_OBJECT, radius=1.2)
        np.save(osp.join(pose_dir, f"{name}.npy"), poses)
        out_dir = osp.join(save_dir, "images", name)
        os.makedirs(out_dir, exist_ok=True)
        command = [
            "blenderproc", "run", script, object_paths[uid],
            osp.join(pose_dir, f"{name}.npy"),
            osp.join(pose_dir, f"{name}.npy"),
            osp.join(pose_dir, f"{name}.npy"),
            out_dir,
        ]
        if dry_run:
            logging.info("DRY RUN: %s", " ".join(command))
            continue
        result = subprocess.run(command, capture_output=True, text=True)
        if result.returncode != 0:
            failed.append(uid)
    write_txt(osp.join(save_dir, "failed_renderings.txt"), failed)
    logging.info("done: %d objects, %d failures", len(uids), len(failed))


def main(argv: list | None = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--annotations", required=True)
    parser.add_argument("--object_paths", required=True)
    parser.add_argument("--blender_script", default=None)
    parser.add_argument("--max_objects", type=int, default=None)
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run(args.save_dir, args.annotations, args.object_paths,
        args.blender_script, args.dry_run, args.max_objects)


if __name__ == "__main__":
    main()
