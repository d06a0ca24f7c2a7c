"""The training item's crop in plain NumPy: an RGBA view composited over
black, then the virtual-bounding-box perspective crop of the reference
recipe (``poses/utils.py``: a 3D box of ``bbox`` metres around the object
origin, its corners projected through K and truncated to integers, the
quad warped to ``size``² with bilinear sampling and a zero border, as
``cv2.warpPerspective`` does).  A frozen copy of the port's
``geometry/cropping.py`` and ``native.composite_rgba_black``; the warp
samples in float64 and rounds to nearest.
"""

from __future__ import annotations

import numpy as np

#: ShapeNet renders' intrinsics (512 px, f = 525)
SHAPENET_K = np.array([[525.0, 0.0, 256.0], [0.0, 525.0, 256.0], [0.0, 0.0, 1.0]])


def composite_black(rgba: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 → (H, W, 3) uint8: rgb·alpha/255, rounded."""
    alpha = rgba[..., 3:4].astype(np.uint32)
    return ((rgba[..., :3].astype(np.uint32) * alpha + 127) // 255).astype(np.uint8)


def homography(pose: np.ndarray, size: int, bbox: float = 1.0, K: np.ndarray = SHAPENET_K) -> np.ndarray:
    """The 3x3 map from the render to the crop of an object at ``pose``
    (4x4, OpenCV camera frame)."""
    pose = np.asarray(pose, np.float64)
    origin = pose[:3, 3]
    up_hint = (pose @ np.append(np.array([0.0, 0.0, 6.0]) - origin, 1.0))[:3]
    right = np.cross(origin, up_hint)
    upper = np.cross(right, origin)
    if np.linalg.norm(upper) == 0 and np.linalg.norm(right) == 0:  # the hint along the line of sight
        upper, right = np.array([0.0, -1.0, 0.0]), np.array([1.0, 0.0, 0.0])
    upper = upper * (bbox / 2) / np.linalg.norm(upper)
    right = right * (bbox / 2) / np.linalg.norm(right)
    corners = np.stack([origin + upper - right, origin - upper - right, origin + upper + right,
                        origin - upper + right])
    proj = corners @ K.T
    src = np.trunc(proj[:, :2] / proj[:, 2:3]).astype(np.int32).astype(np.float64)
    dst = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float64) * size
    A, b = np.zeros((8, 8)), np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src, dst)):
        A[2 * i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[2 * i], b[2 * i + 1] = u, v
    return np.append(np.linalg.solve(A, b), 1.0).reshape(3, 3)


def warp(img: np.ndarray, M: np.ndarray, size: int) -> np.ndarray:
    """dst(x, y) = img(M⁻¹·(x, y, 1)), bilinear, zero outside; float64."""
    h, w, c = img.shape
    inv = np.linalg.inv(M)
    ys, xs = np.mgrid[:size, :size].astype(np.float64)
    den = inv[2, 0] * xs + inv[2, 1] * ys + inv[2, 2]
    u = (inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]) / den
    v = (inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]) / den
    u0, v0 = np.floor(u), np.floor(v)
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    src = img.astype(np.float64)

    def at(vi, ui):
        inside = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        vals = src[np.clip(vi, 0, h - 1).astype(np.int64), np.clip(ui, 0, w - 1).astype(np.int64)]
        return vals * inside[..., None]

    top = at(v0, u0) * (1 - du) + at(v0, u0 + 1) * du
    bottom = at(v0 + 1, u0) * (1 - du) + at(v0 + 1, u0 + 1) * du
    return top * (1 - dv) + bottom * dv


def crop(rgba: np.ndarray, pose: np.ndarray, size: int) -> np.ndarray:
    """(size, size, 3) uint8: the training item's view of ``rgba`` at ``pose``."""
    out = warp(composite_black(rgba), homography(pose, size), size)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
