"""3D debug visualization (``nope_tpu/utils/vis_3d.py``; the reference's
``src/utils/vis_3d_utils.py``): point clouds and camera frustums for
inspecting pose grids.  open3d is optional and imported by each
function, so a host without it gets the ``ImportError`` at the call.
"""

from __future__ import annotations

import numpy as np


def convert_numpy_to_open3d(points: np.ndarray, colors: np.ndarray | None = None):
    import open3d as o3d

    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(np.asarray(points, dtype=np.float64))
    if colors is not None:
        pcd.colors = o3d.utility.Vector3dVector(np.asarray(colors, dtype=np.float64))
    return pcd


def draw_camera(cam2world: np.ndarray, scale: float = 0.1, color=(1.0, 0.0, 0.0)):
    """Camera frustum line set for a 4x4 camera-to-world pose."""
    import open3d as o3d

    pts_cam = scale * np.array(
        [
            [0, 0, 0], [-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2],
        ],
        dtype=np.float64,
    )
    R, t = cam2world[:3, :3], cam2world[:3, 3]
    pts = pts_cam @ R.T + t
    lines = [[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]]
    ls = o3d.geometry.LineSet(
        points=o3d.utility.Vector3dVector(pts),
        lines=o3d.utility.Vector2iVector(lines),
    )
    ls.colors = o3d.utility.Vector3dVector([color] * len(lines))
    return ls


def draw_pose_grid(level: int = 0, pose_distribution: str = "all"):
    """Show a template grid's cameras around the origin."""
    import open3d as o3d

    from nope_tpu_torch.geometry.so3_grid import get_obj_poses_from_template_level

    cams = get_obj_poses_from_template_level(
        level, pose_distribution, return_cam=True
    )
    geoms = [draw_camera(c, scale=0.05) for c in cams]
    geoms.append(o3d.geometry.TriangleMesh.create_coordinate_frame(size=0.3))
    o3d.visualization.draw_geometries(geoms)
