"""Raw-Blender Objaverse renderer (CYCLES/EEVEE)
(``nope_tpu/scripts/blender_objaverse.py``).

The reference's ``src/poses/blender_objaverse.py``
(``BlenderInterface``, lines 134-260): renders GLB objects from a
(n, 4, 4) OpenCV object-pose array inside Blender's bundled Python —

    blender -b -P nope_tpu_torch/scripts/blender_objaverse.py -- \
        --cad-path obj.glb --pose-path poses.npy --output-dir out/

Design differences from the reference (behavior preserved):

- the pose math (OpenCV↔Blender camera conversion, pose inversion) is
  pure numpy and importable without ``bpy``, so it is unit-tested on
  any host; only the scene code needs Blender;
- the engine choice actually takes effect (the reference sets
  ``engine = name_engine`` then immediately overwrites it with CYCLES,
  blender_objaverse.py:144-153) — EEVEE renders use EEVEE here;
- GPU setup degrades to CPU rendering instead of asserting when no
  CUDA device exists.

The blenderproc path (``nope_tpu_torch/scripts/generate_objaverse.py``) remains the
default production renderer; this module covers the reference's raw
CYCLES/EEVEE capability.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Optional, Sequence

import numpy as np

# camera-frame flip between OpenCV (+z forward, y down) and Blender
# (-z forward, y up)
_CV_TO_BLENDER = np.diag([1.0, -1.0, -1.0])


def inverse_transform(trans: np.ndarray) -> np.ndarray:
    """Rigid-transform inverse (``blender_objaverse.py:12-21``):
    object-to-camera pose → camera-to-world (object at origin)."""
    trans = np.asarray(trans, dtype=np.float64)
    out = np.eye(4)
    rot = trans[:3, :3].T
    out[:3, :3] = rot
    out[:3, 3] = -rot @ trans[:3, 3]
    return out


def opencv_cam2world_to_blender(cv_cam2world: np.ndarray) -> np.ndarray:
    """OpenCV camera-to-world matrix → Blender ``matrix_world``
    (``blender_objaverse.py:24-54``).  Algebraically the whole
    Matrix dance there reduces to: same camera location, rotation
    columns y/z negated (R_blender = R_cv @ diag(1,-1,-1))."""
    cv_cam2world = np.asarray(cv_cam2world, dtype=np.float64)
    out = np.eye(4)
    out[:3, :3] = cv_cam2world[:3, :3] @ _CV_TO_BLENDER
    out[:3, 3] = cv_cam2world[:3, 3]
    return out


def object_poses_to_blender_cam(obj_poses: np.ndarray) -> np.ndarray:
    """(n, 4, 4) OpenCV object poses → (n, 4, 4) Blender camera
    matrix_worlds (the ``__main__`` composition,
    ``blender_objaverse.py:240-242``)."""
    return np.stack(
        [opencv_cam2world_to_blender(inverse_transform(p)) for p in obj_poses]
    )


def kinect_focal_px(resolution: int) -> float:
    """The reference's focal convention: 525 px at 512² scaled to the
    render resolution (``blender_objaverse.py:193-195``)."""
    return 525.0 / 512.0 * resolution


def light_rig_positions(position: float = 1.0) -> list:
    """The 8-point light rig corners (``blender_objaverse.py:164-180``)."""
    return [
        (position * x, position * y, position * z)
        for x in (-1, 1)
        for y in (-1, 1)
        for z in (0, 1)
    ]


class BlenderInterface:
    """The Blender scene; requires running under Blender's Python (bpy)."""

    def __init__(
        self,
        gpu_ids: str = "",
        name_engine: str = "CYCLES",
        resolution: int = 512,
        samples: int = 32,
    ):
        import bpy

        self._bpy = bpy
        if name_engine not in ("CYCLES", "BLENDER_EEVEE", "BLENDER_WORKBENCH"):
            raise ValueError(f"unknown engine {name_engine!r}")
        self.resolution = resolution

        bpy.ops.object.delete()  # the default cube

        self.scene = bpy.context.scene
        render = self.scene.render
        render.engine = name_engine
        render.image_settings.file_format = "PNG"
        render.image_settings.color_mode = "RGBA"
        render.resolution_x = resolution
        render.resolution_y = resolution
        render.resolution_percentage = 100
        render.film_transparent = True

        if name_engine == "CYCLES":
            self._setup_cycles(gpu_ids, samples)

        for i, location in enumerate(light_rig_positions()):
            self._add_light(location)

        self.camera = bpy.context.scene.camera
        self.camera.data.sensor_height = self.camera.data.sensor_width
        self._set_focal_px(kinect_focal_px(resolution))
        bpy.ops.object.select_all(action="DESELECT")

    def _setup_cycles(self, gpu_ids: str, samples: int) -> None:
        bpy = self._bpy
        cycles = self.scene.cycles
        cycles.samples = samples
        cycles.diffuse_bounces = 1
        cycles.glossy_bounces = 1
        cycles.transparent_max_bounces = 3
        cycles.transmission_bounces = 3
        cycles.filter_width = 0.01
        cycles.use_denoising = True
        try:
            prefs = bpy.context.preferences.addons["cycles"].preferences
            prefs.get_devices()
            if gpu_ids:
                os.environ["CUDA_VISIBLE_DEVICES"] = gpu_ids
            prefs.compute_device_type = "CUDA"
            cycles.device = "GPU"
        except Exception:  # Blender found no CUDA device: it renders on the CPU, and says so
            logging.warning("Cycles: no CUDA device (%s); rendering on the CPU", gpu_ids or "default")
            cycles.device = "CPU"

    def _add_light(self, location, energy: float = 100.0) -> None:
        bpy = self._bpy
        bpy.ops.object.light_add(type="POINT", location=location)
        light_obj = bpy.context.object
        light_obj.data.use_shadow = False
        light_obj.data.specular_factor = 0.0
        light_obj.data.energy = energy
        light_obj.scale = (100, 100, 100)

    def _set_focal_px(self, focal_px: float) -> None:
        """Focal length in pixels → lens mm via the sensor model
        (``blender_objaverse.py:115-131``)."""
        cam = self.camera.data
        render = self.scene.render
        scale = render.resolution_percentage / 100
        pixel_aspect = render.pixel_aspect_x / render.pixel_aspect_y
        if cam.sensor_fit == "VERTICAL":
            s_u = render.resolution_x * scale / cam.sensor_width / pixel_aspect
        else:
            s_u = render.resolution_x * scale / cam.sensor_width
        cam.lens = focal_px / s_u

    # -- scene content -------------------------------------------------------

    def import_mesh(self, fpath: str, scale: float = 1.0):
        """GLTF import + unit-box normalization (0.8 box, centered)
        (``blender_objaverse.py:201-215`` + ``normalize_scene``)."""
        bpy = self._bpy
        bpy.ops.import_scene.gltf(filepath=str(fpath), merge_vertices=True)
        obj = bpy.context.selected_objects[0]
        bpy.ops.object.origin_set(type="ORIGIN_GEOMETRY", center="BOUNDS")
        obj.rotation_mode = "XYZ"
        obj.location = (0.0, 0.0, 0.0)
        obj.rotation_euler[0] = -math.pi / 2  # gltf y-up → blender z-up
        if scale != 1.0:
            bpy.ops.transform.resize(value=(scale, scale, scale))
        return self._normalize_scene(scale_scene=0.8)

    def _scene_meshes(self):
        bpy = self._bpy
        return [o for o in bpy.context.scene.objects.values()
                if isinstance(o.data, bpy.types.Mesh)]

    def _scene_bbox(self):
        from mathutils import Vector

        lo = [math.inf] * 3
        hi = [-math.inf] * 3
        meshes = self._scene_meshes()
        if not meshes:
            raise RuntimeError("no meshes in scene")
        for obj in meshes:
            for corner in obj.bound_box:
                world = obj.matrix_world @ Vector(corner)
                lo = [min(a, b) for a, b in zip(lo, world)]
                hi = [max(a, b) for a, b in zip(hi, world)]
        return Vector(lo), Vector(hi)

    def _normalize_scene(self, scale_scene: float = 1.0):
        bpy = self._bpy
        lo, hi = self._scene_bbox()
        scale = scale_scene / max(hi - lo)
        roots = [o for o in bpy.context.scene.objects.values() if not o.parent]
        for obj in roots:
            obj.scale = obj.scale * scale
        bpy.context.view_layer.update()
        lo, hi = self._scene_bbox()
        offset = -(lo + hi) / 2
        for obj in roots:
            obj.matrix_world.translation += offset
        bpy.ops.object.select_all(action="DESELECT")
        return scale, offset

    # -- rendering -----------------------------------------------------------

    def render(self, output_dir: str, blender_cam2worlds: Sequence[np.ndarray]):
        from mathutils import Matrix

        bpy = self._bpy
        os.makedirs(output_dir, exist_ok=True)
        for i, matrix in enumerate(blender_cam2worlds):
            self.camera.matrix_world = Matrix(np.asarray(matrix).tolist())
            self.scene.render.filepath = os.path.join(output_dir, f"{i:06d}.png")
            bpy.ops.render.render(write_still=True)


def main(argv: Optional[list] = None) -> None:
    import argparse
    import sys

    if argv is None:  # blender passes script args after "--"
        argv = sys.argv[sys.argv.index("--") + 1:] if "--" in sys.argv else []
    parser = argparse.ArgumentParser()
    parser.add_argument("--cad-path", required=True)
    parser.add_argument("--pose-path", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--gpu-id", default="")
    parser.add_argument("--engine", default="CYCLES",
                        choices=("CYCLES", "BLENDER_EEVEE", "BLENDER_WORKBENCH"))
    parser.add_argument("--resolution", type=int, default=512)
    args = parser.parse_args(argv)

    obj_poses = np.load(args.pose_path)
    blender_poses = object_poses_to_blender_cam(obj_poses)

    renderer = BlenderInterface(
        gpu_ids=args.gpu_id, name_engine=args.engine, resolution=args.resolution
    )
    renderer.import_mesh(args.cad_path, scale=1.0)
    renderer.render(args.output_dir, blender_poses)


if __name__ == "__main__":
    main()
