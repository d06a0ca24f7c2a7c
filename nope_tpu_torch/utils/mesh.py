"""Trimesh helpers (``nope_tpu/utils/mesh.py``): scene → one mesh,
bounds-centred loading, diameters, AABB corners.

trimesh is optional: it is imported by the functions that need it, so
this module imports anywhere, and a caller on a host without trimesh
gets the ``ImportError`` when it loads a mesh.  Only VSD's pyrender
route (:func:`nope_tpu_torch.evaluation.vsd.make_renderer`) and the BOP
reader's CAD table use it.
"""

from __future__ import annotations

import numpy as np


def as_mesh(scene_or_mesh):
    import trimesh

    if isinstance(scene_or_mesh, trimesh.Scene):
        return trimesh.util.concatenate(
            [trimesh.Trimesh(vertices=m.vertices, faces=m.faces) for m in scene_or_mesh.geometry.values()]
        )
    return scene_or_mesh


def load_mesh(path: str, origin_geometry: str = "BOUNDS"):
    import trimesh

    mesh = as_mesh(trimesh.load(path))
    if origin_geometry == "BOUNDS":
        center = np.mean(mesh.bounds, axis=0)
        mesh.vertices -= center
    return mesh


def aabb_corners(aabb: np.ndarray) -> np.ndarray:
    """(2, 3) min/max bounds → (8, 3) box corners."""
    mn, mx = aabb
    xs = [mn[0], mx[0]]
    ys = [mn[1], mx[1]]
    zs = [mn[2], mx[2]]
    return np.array(
        [
            [xs[0], ys[0], zs[0]], [xs[1], ys[0], zs[0]],
            [xs[1], ys[1], zs[0]], [xs[0], ys[1], zs[0]],
            [xs[0], ys[0], zs[1]], [xs[1], ys[0], zs[1]],
            [xs[1], ys[1], zs[1]], [xs[0], ys[1], zs[1]],
        ]
    )


def get_obj_diameter(mesh_path: str) -> float:
    mesh = load_mesh(mesh_path)
    return float(np.linalg.norm(mesh.extents * 2))
