"""ShapeNet rendering-dataset generator
(``nope_tpu/scripts/generate_data.py``).

The reference's ``src/scripts/generate_data.py``: the offline pipeline
that makes the training set, 652 RGBA images per object (5 query + 5
reference + 642 level-2 templates at 512², K =
[[525,0,256],[0,525,256],[0,0,1]]), with the reference's bugs fixed as
the JAX package fixes them: the render subprocess is actually run (the
reference comments out its ``os.system`` call, ``generate_data.py:123``)
and failures are persisted for re-queueing.

Steps::

    python -m nope_tpu_torch.scripts.generate_data --step select_cad \\
        --shapenet_dir ... --save_dir ...
    python -m nope_tpu_torch.scripts.generate_data --step generate_poses_and_images \\
        --save_dir ... [--dry-run]

Rendering runs the external ``blenderproc`` binary on this package's
``blenderproc_render.py``; everything else is numpy.  Worker pools are
``spawn`` processes, so it may be called from a process that
holds threads or a CUDA context.
"""

from __future__ import annotations

import argparse
import glob
import logging
import multiprocessing
import os
import os.path as osp
import subprocess
from functools import partial
from typing import List, Optional, Tuple

import numpy as np

from nope_tpu_torch.geometry.so3_grid import get_obj_poses_from_template_level
from nope_tpu_torch.geometry.transforms import (
    inverse_transform_numpy,
    look_at,
    spherical_to_cartesian,
)
from nope_tpu_torch.utils.inout import load_json, open_txt, save_json, write_txt

IMAGES_PER_OBJECT = 652  # 5 query + 5 reference + 642 templates
NUM_QUERY = 5
NUM_REFERENCE = 5


def _pool(num_workers: int):
    return multiprocessing.get_context("spawn").Pool(num_workers)


# ---------------------------------------------------------------------------
# step 1: CAD selection
# ---------------------------------------------------------------------------


def select_cad_with_texture(cad_dir: str) -> Optional[Tuple[str, float]]:
    """Keep CADs that ship textures; return (path, diameter)
    (``generate_data.py:22-47``).  A CAD whose mesh does not load (or a
    host without trimesh) is dropped, as in the JAX package."""
    model_path = osp.join(cad_dir, "models", "model_normalized.obj")
    texture_dir = osp.join(cad_dir, "images")
    if not osp.exists(model_path):
        return None
    has_texture = osp.isdir(texture_dir) and len(os.listdir(texture_dir)) > 0
    if not has_texture:
        return None
    try:
        from nope_tpu_torch.utils.mesh import get_obj_diameter

        # reference semantics: norm(extents * 2) (trimesh_utils.py:74)
        diameter = float(get_obj_diameter(model_path))
    except Exception:  # any mesh that does not load: the CAD is not selected
        return None
    return model_path, diameter


def run_select_cad(shapenet_dir: str, save_dir: str, num_workers: int = 8) -> None:
    cad_dirs: List[str] = []
    for synset in sorted(os.listdir(shapenet_dir)):
        synset_dir = osp.join(shapenet_dir, synset)
        if not osp.isdir(synset_dir):
            continue
        for cad_id in sorted(os.listdir(synset_dir)):
            cad_dirs.append(osp.join(synset_dir, cad_id))
    logging.info("probing %d CADs", len(cad_dirs))
    with _pool(num_workers) as pool:
        results = pool.map(select_cad_with_texture, cad_dirs)

    paths, names, diameters = [], [], {}
    for cad_dir, res in zip(cad_dirs, results):
        if res is None:
            continue
        path, diameter = res
        synset, cad_id = cad_dir.split("/")[-2:]
        paths.append(path)
        names.append(f"{synset}_{cad_id}")
        diameters[f"{synset}_{cad_id}"] = diameter
    os.makedirs(save_dir, exist_ok=True)
    write_txt(osp.join(save_dir, "cad_paths.txt"), paths)
    write_txt(osp.join(save_dir, "cad_names.txt"), names)
    save_json(osp.join(save_dir, "obj_diameter.json"), diameters)
    logging.info("selected %d textured CADs", len(paths))


# ---------------------------------------------------------------------------
# step 2: pose sampling + rendering
# ---------------------------------------------------------------------------


def sample_camera_poses(rng: np.random.Generator, n: int, radius: float) -> np.ndarray:
    """Random upper-hemisphere look-at object poses
    (``generate_data.py:50-88``): azimuth U(0, 2π), elevation U(0, π/2),
    camera at ``radius``, pose = inverse(cam2world)."""
    poses = []
    for _ in range(n):
        azimuth = rng.uniform(0, 2 * np.pi)
        elevation = rng.uniform(0, np.pi / 2)
        loc = spherical_to_cartesian(azimuth, elevation, 1.0)
        cam = look_at(loc, np.zeros(3))
        obj = inverse_transform_numpy(cam)
        obj[:3, 3] *= radius
        poses.append(obj)
    return np.stack(poses)


def generate_object_poses(
    obj_id: int, save_dir: str, diameter: float, seed: int = 2022
) -> None:
    rng = np.random.default_rng(seed + obj_id)
    radius = 1.2 * diameter
    name = f"obj_{obj_id:06d}"
    for kind, n in (("query", NUM_QUERY), ("reference", NUM_REFERENCE)):
        out_dir = osp.join(save_dir, f"object_{kind}_poses")
        os.makedirs(out_dir, exist_ok=True)
        np.save(osp.join(out_dir, f"{name}.npy"), sample_camera_poses(rng, n, radius))
    # template poses: the level-2 grid rescaled to the object's size
    templates = get_obj_poses_from_template_level(2, "all").copy()
    templates[:, :3, 3] *= radius / 0.5  # grid stores 0.5 m distance
    out_dir = osp.join(save_dir, "object_template_poses")
    os.makedirs(out_dir, exist_ok=True)
    np.save(osp.join(out_dir, f"{name}.npy"), templates)


def call_blenderproc(
    obj_id: int,
    cad_paths: List[str],
    save_dir: str,
    blenderproc_script: str,
    dry_run: bool = False,
) -> bool:
    """Render one object; success == 652 PNGs
    (``generate_data.py:91-126``, with the os.system actually run)."""
    name = f"obj_{obj_id:06d}"
    out_dir = osp.join(save_dir, "images", name)
    os.makedirs(out_dir, exist_ok=True)
    command = [
        "blenderproc", "run", blenderproc_script,
        cad_paths[obj_id],
        osp.join(save_dir, "object_query_poses", f"{name}.npy"),
        osp.join(save_dir, "object_reference_poses", f"{name}.npy"),
        osp.join(save_dir, "object_template_poses", f"{name}.npy"),
        out_dir,
    ]
    if dry_run:
        logging.info("DRY RUN: %s", " ".join(command))
        return True
    result = subprocess.run(command, capture_output=True, text=True)
    if result.returncode != 0:
        logging.warning("render failed for %s: %s", name, result.stderr[-500:])
        return False
    num_images = len(glob.glob(osp.join(out_dir, "*.png")))
    return num_images == IMAGES_PER_OBJECT


def run_generate(
    save_dir: str,
    blenderproc_script: Optional[str] = None,
    num_workers: int = 4,
    dry_run: bool = False,
    start: int = 0,
    end: Optional[int] = None,
) -> None:
    cad_paths = open_txt(osp.join(save_dir, "cad_paths.txt"))
    cad_names = open_txt(osp.join(save_dir, "cad_names.txt"))
    diameters = load_json(osp.join(save_dir, "obj_diameter.json"))
    end = len(cad_paths) if end is None else min(end, len(cad_paths))

    with _pool(num_workers) as pool:
        pool.starmap(
            generate_object_poses,
            [(i, save_dir, diameters[cad_names[i]]) for i in range(start, end)],
        )
    logging.info("poses written for objects [%d, %d)", start, end)

    script = blenderproc_script or osp.join(
        osp.dirname(osp.abspath(__file__)), "blenderproc_render.py"
    )
    render = partial(
        call_blenderproc,
        cad_paths=cad_paths,
        save_dir=save_dir,
        blenderproc_script=script,
        dry_run=dry_run,
    )
    failed: List[str] = []
    with _pool(num_workers) as pool:
        for obj_id, ok in zip(range(start, end), pool.map(render, range(start, end))):
            if not ok:
                failed.append(f"{obj_id}")
    write_txt(osp.join(save_dir, f"failed_renderings_{start}_{end}.txt"), failed)
    logging.info("rendering done; %d failures persisted for re-queue", len(failed))


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--step", required=True, choices=["select_cad", "generate_poses_and_images"]
    )
    parser.add_argument("--shapenet_dir")
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--blenderproc_script", default=None)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, default=None)
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.step == "select_cad":
        if not args.shapenet_dir:
            parser.error("--shapenet_dir required for select_cad")
        run_select_cad(args.shapenet_dir, args.save_dir, args.num_workers)
    else:
        run_generate(
            args.save_dir, args.blenderproc_script, args.num_workers,
            args.dry_run, args.start, args.end,
        )


if __name__ == "__main__":
    main()
