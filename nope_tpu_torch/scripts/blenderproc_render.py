"""BlenderProc render script (runs inside ``blenderproc run``), a copy of
``nope_tpu/scripts/blenderproc_render.py``: the script that
``generate_data`` and ``generate_objaverse`` name by default.  It runs in
BlenderProc's own Python and is never imported by the package.

The reference's ``src/poses/blenderproc.py``: camera fixed
at the origin with K = [[525,0,256],[0,525,256],[0,0,1]], four point
lights, the CAD loaded with origin-to-bounds centring, and one
transparent-background 512² RGBA render per object pose (the object is
moved, not the camera).  Query/reference/template pose files come from
``generate_data.py``.

Usage (as ``generate_data`` calls it)::

    blenderproc run blenderproc_render.py <cad_path> <query_poses.npy> \
        <reference_poses.npy> <template_poses.npy> <out_dir> [--tless_like]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

import blenderproc as bproc  # noqa: E402  (provided by the blenderproc runtime)


K = np.array([[525.0, 0, 256], [0, 525.0, 256], [0, 0, 1]])
IMG_SIZE = 512

# OpenCV camera → Blender camera frame
CV2BLENDER = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float64
)


def render_poses(obj, poses: np.ndarray, out_dir: str, prefix: str) -> None:
    for idx in range(len(poses)):
        # object moved under a fixed camera at the origin: with the
        # OpenCV object pose P (x_cam = P·x_obj) and the Blender camera
        # frame CV2BLENDER, the object's world transform is CV2BLENDER·P
        obj.set_local2world_mat(CV2BLENDER @ poses[idx])
        data = bproc.renderer.render()
        rgba = data["colors"][0]
        from PIL import Image

        Image.fromarray(rgba.astype(np.uint8)).save(
            osp.join(out_dir, f"{prefix}_{idx:06d}.png")
        )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("cad_path")
    parser.add_argument("query_poses")
    parser.add_argument("reference_poses")
    parser.add_argument("template_poses")
    parser.add_argument("out_dir")
    parser.add_argument("--tless_like", action="store_true",
                        help="uniform grey material (T-LESS style)")
    args = parser.parse_args()

    bproc.init()
    bproc.camera.set_intrinsics_from_K_matrix(K, IMG_SIZE, IMG_SIZE)
    # camera at origin looking down +z (OpenCV), i.e. Blender -Z
    bproc.camera.add_camera_pose(CV2BLENDER @ np.eye(4))

    objs = bproc.loader.load_obj(args.cad_path)
    obj = objs[0]
    # origin-to-bounds centring (blenderproc.py ShapeNet loader option)
    bbox = np.array(obj.get_bound_box())
    obj.set_origin(bbox.mean(axis=0))
    if args.tless_like:
        for mat in obj.get_materials():
            mat.set_principled_shader_value("Base Color", [0.6, 0.6, 0.6, 1.0])

    for loc in ([1, 1, 1], [-1, -1, 1], [1, -1, -1], [-1, 1, -1]):
        light = bproc.types.Light()
        light.set_type("POINT")
        light.set_location(loc)
        light.set_energy(50)

    bproc.renderer.set_output_format(enable_transparency=True)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, path in (
        ("query", args.query_poses),
        ("reference", args.reference_poses),
        ("templates", args.template_poses),
    ):
        render_poses(obj, np.load(path), args.out_dir, name)


if __name__ == "__main__":
    main()
