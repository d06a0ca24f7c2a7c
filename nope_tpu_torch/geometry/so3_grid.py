"""SO(3) viewpoint template grids (icosphere levels 0-3), numpy only.

Loaders of ``nope_tpu/geometry/so3_grid.py``, over the port's own copy
of its ``.npy`` assets (``assets/``, byte-identical to
``nope_tpu/geometry/assets/predefined_poses/``).
"""

from __future__ import annotations

import functools
import os

import numpy as np

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
