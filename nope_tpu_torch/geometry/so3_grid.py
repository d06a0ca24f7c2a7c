"""SO(3) viewpoint template grids (icosphere levels 0-3), numpy only.

``nope_tpu/geometry/so3_grid.py``: the loaders over the port's own copy
of its ``.npy`` assets (``assets/``, byte-identical to
``nope_tpu/geometry/assets/predefined_poses/``), the template-id map,
the generator that rebuilds the assets (icosphere vertices stable-sorted
by z, OpenCV look-at toward the origin, inverse poses 0.5 m away) and
:class:`NearestTemplateFinder`, which snaps object poses to the grid.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from nope_tpu_torch.geometry.transforms import (
    compute_inplane,
    inverse_transform_numpy,
    look_at,
    opencv2opengl_numpy,
)

_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

#: number of grid poses per level (icosphere vertex counts)
LEVEL_SIZES = {0: 42, 1: 162, 2: 642, 3: 2562}


@functools.lru_cache(maxsize=None)
def _load_asset(name: str) -> np.ndarray:
    arr = np.load(os.path.join(_ASSET_DIR, f"{name}.npy"))
    arr.setflags(write=False)
    return arr


def load_cam_poses(level: int) -> np.ndarray:
    """(N, 4, 4) camera-to-world poses on the unit sphere."""
    return _load_asset(f"sphere_poses_level{level}")


def load_obj_poses(level: int) -> np.ndarray:
    """(N, 4, 4) world-to-camera object poses (camera distance 0.5)."""
    return _load_asset(f"obj_poses_level{level}")


def get_obj_poses_from_template_level(
    level: int,
    pose_distribution: str = "all",
    return_cam: bool = False,
    return_index: bool = False,
):
    """``pose_distribution`` in {"all", "upper"}; "upper" keeps poses
    whose *camera* z >= 0."""
    poses = load_cam_poses(level) if return_cam else load_obj_poses(level)
    if pose_distribution == "all":
        index = np.arange(len(poses))
    elif pose_distribution == "upper":
        cam = load_cam_poses(level)
        index = np.arange(len(poses))[cam[:, 2, 3] >= 0]
        poses = poses[cam[:, 2, 3] >= 0]
    else:
        raise ValueError(f"unknown pose_distribution {pose_distribution!r}")
    if return_index:
        return index, np.array(poses)
    return np.array(poses)


def load_index_level0_in_level2(pose_distribution: str = "upper") -> np.ndarray:
    """Nearest level-2 grid index of each level-0 pose (42 entries for
    "all", 26 for "upper")."""
    return np.array(_load_asset(f"idx_{pose_distribution}_level0_in_level2"))


def load_mapping_id_templates_to_idx_pose_distribution(
    level: int, pose_distribution: str
) -> dict[int, int]:
    """Template id → position within the filtered distribution."""
    index_range, _ = get_obj_poses_from_template_level(
        level=level, pose_distribution=pose_distribution, return_index=True
    )
    return {int(idx): i for i, idx in enumerate(index_range)}


# ---------------------------------------------------------------------------
# programmatic generation (the assets' construction)
# ---------------------------------------------------------------------------


def icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron in the pole orientation the grids were built
    from: vertices at (0,0,±1) and two pentagonal rings at z = ±1/√5,
    the upper ring at azimuths 72k°, the lower at 36°+72k°."""
    z_ring = 1.0 / np.sqrt(5.0)
    r_ring = 2.0 / np.sqrt(5.0)
    upper_az = np.deg2rad(72.0 * np.arange(5))
    lower_az = np.deg2rad(36.0 + 72.0 * np.arange(5))
    verts = np.concatenate(
        [
            np.array([[0.0, 0.0, 1.0]]),
            np.stack([r_ring * np.cos(upper_az), r_ring * np.sin(upper_az), np.full(5, z_ring)], axis=1),
            np.stack([r_ring * np.cos(lower_az), r_ring * np.sin(lower_az), np.full(5, -z_ring)], axis=1),
            np.array([[0.0, 0.0, -1.0]]),
        ]
    )
    faces = []
    for i in range(5):
        j = (i + 1) % 5
        u_i, u_j = 1 + i, 1 + j
        l_i, l_j = 6 + i, 6 + j
        faces += [
            [0, u_i, u_j],  # north cap
            [u_i, l_i, u_j],  # upper band
            [u_j, l_i, l_j],  # lower band
            [11, l_j, l_i],  # south cap
        ]
    return verts, np.asarray(faces, dtype=np.int64)


def icosphere(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """Subdivide the icosahedron, projecting midpoints onto the sphere.
    Vertex counts: 12, 42, 162, 642, 2562, ..."""
    verts, faces = icosahedron()
    for _ in range(subdivisions):
        verts_list = list(verts)
        midpoint_cache: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in midpoint_cache:
                m = (verts_list[a] + verts_list[b]) / 2.0
                m = m / np.linalg.norm(m)
                midpoint_cache[key] = len(verts_list)
                verts_list.append(m)
            return midpoint_cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts, faces


def generate_so3_grid(level: int, radius: float = 1.0, obj_distance: float = 0.5):
    """(sphere_poses, obj_poses) of a grid level, built from scratch:
    icosphere(level+1) vertices stable-sorted by z, OpenCV look-at toward
    the origin, and inverse poses with the translation rescaled to
    ``obj_distance``."""
    verts, _ = icosphere(level + 1)
    order = np.argsort(verts[:, 2], kind="stable")
    verts = verts[order] * radius

    sphere_poses = np.stack([look_at(v, np.zeros(3)) for v in verts])
    obj_poses = np.stack([inverse_transform_numpy(p) for p in sphere_poses]).astype(np.float64)
    obj_poses[:, :3, 3] *= obj_distance / radius
    return sphere_poses, obj_poses


# ---------------------------------------------------------------------------
# nearest-template search
# ---------------------------------------------------------------------------


class NearestTemplateFinder:
    """Map arbitrary object poses to the nearest grid template.

    The distance is euclidean between OpenGL viewing directions (row 2
    of the OpenGL-converted pose), the nearest the first ``np.argmin`` of
    the squared distances; optionally also the residual in-plane angle.
    """

    def __init__(
        self,
        level_templates: int,
        pose_distribution: str = "all",
        return_inplane: bool = False,
        normalize_query_translation: bool = True,
    ):
        self.level_templates = level_templates
        self.pose_distribution = pose_distribution
        self.return_inplane = return_inplane
        self.normalize_query_translation = normalize_query_translation
        self.avail_index, self.obj_template_poses = get_obj_poses_from_template_level(
            level_templates, pose_distribution, return_cam=False, return_index=True
        )
        self.obj_template_openGL_poses = opencv2opengl_numpy(self.obj_template_poses)

    def search_nearest_template(self, obj_query_pose: np.ndarray):
        obj_query_pose = np.asarray(obj_query_pose).reshape(-1, 4, 4)
        query_gl = opencv2opengl_numpy(obj_query_pose)
        q_loc = query_gl[:, 2, :3]  # (M, 3) viewing directions
        t_loc = self.obj_template_openGL_poses[:, 2, :3]  # (N, 3)

        d2 = np.sum((q_loc[:, None, :] - t_loc[None, :, :]) ** 2, axis=-1)
        best = np.argmin(d2, axis=-1)
        if not self.return_inplane:
            return self.avail_index[best]
        nearest_poses = self.obj_template_poses[best]
        inplanes = np.array(
            [
                compute_inplane(obj_query_pose[i, :3, :3], nearest_poses[i, :3, :3])
                for i in range(len(obj_query_pose))
            ]
        )
        return self.avail_index[best], inplanes
