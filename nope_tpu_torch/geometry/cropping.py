"""Virtual-bounding-box perspective crop (``nope_tpu/geometry/cropping.py``).

The reference's only image preprocessing step: build a metric virtual
3D bbox around the object centre in camera space, project its 4 corners
through K, and warp the quad to an ``image_size²`` crop.

Two halves:

- **host** (:func:`crop_frame`, numpy): cv2 where it is importable, as
  the JAX package does; else the native C++ warp
  (:mod:`nope_tpu_torch.native`), which itself falls back to
  :func:`warp_perspective_torch` on CPU tensors where its library cannot
  be built;
- **tensor** (:func:`crop_frame_torch`, :func:`warp_perspective_torch`,
  :func:`get_perspective_transform_torch`): plain PyTorch on tensors of
  any device, batched over a leading dim where the JAX package uses
  ``vmap``.

Reference quirks reproduced deliberately (they shift the homography by
up to a pixel and matter for embedding-level parity):
- projected corners are truncated toward zero to int32 before the
  homography is solved (``utils.py:55-56,258``);
- the non-inplane up-vector hint applies the *full* pose (including
  translation) to ``(0,0,6) - origin_in_cam`` (``utils.py:230-231``).

The tensor half builds the corners in float32, as the JAX package does,
solves the 8x8 homography system in float64 (as the host does; the JAX
package's float32 solve departs from it at 512-px corner coordinates)
and warps with float32 coordinates and weights.  Where the up hint is
parallel to the line of sight it takes the host's fallback axes, which
the JAX package's device crop lacks.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# shared corner construction (numpy)
# ---------------------------------------------------------------------------


def virtual_bbox_corners(
    openCV_pose: np.ndarray,
    virtual_bbox_size: float,
    keep_inplane: bool = False,
) -> np.ndarray:
    """(4, 3) camera-space corners of the virtual bbox around the object
    origin, ordered (+u-r, -u-r, +u+r, -u+r) like the reference."""
    origin_in_cam = (np.asarray(openCV_pose, dtype=np.float64) @ np.array([0, 0, 0, 1.0]))[:3]
    if keep_inplane:
        upper = np.array([0.0, -origin_in_cam[2], origin_in_cam[1]])
        right = np.array(
            [
                origin_in_cam[1] ** 2 + origin_in_cam[2] ** 2,
                -origin_in_cam[0] * origin_in_cam[1],
                -origin_in_cam[0] * origin_in_cam[2],
            ]
        )
        if np.linalg.norm(upper) == 0 and np.linalg.norm(right) == 0:
            upper = np.array([0.0, -1.0, 0.0])
            right = np.array([1.0, 0.0, 0.0])
    else:
        upV = np.array([0.0, 0.0, 6.0]) - origin_in_cam
        upV = (np.asarray(openCV_pose) @ np.array([upV[0], upV[1], upV[2], 1.0]))[:3]
        right = np.cross(origin_in_cam, upV)
        upper = np.cross(right, origin_in_cam)
        if np.linalg.norm(upper) == 0 and np.linalg.norm(right) == 0:
            upper = np.array([0.0, -1.0, 0.0])
            right = np.array([1.0, 0.0, 0.0])

    upper = upper * (virtual_bbox_size / 2) / np.linalg.norm(upper)
    right = right * (virtual_bbox_size / 2) / np.linalg.norm(right)

    return np.stack(
        (
            origin_in_cam + upper - right,
            origin_in_cam - upper - right,
            origin_in_cam + upper + right,
            origin_in_cam - upper + right,
        )
    )


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography mapping 4 src points to 4 dst points
    (cv2.getPerspectiveTransform equivalent, 8x8 linear solve)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[2 * i], b[2 * i + 1] = u, v
    h = np.linalg.solve(A, b)
    return np.append(h, 1.0).reshape(3, 3)


def crop_homography(
    intrinsic: np.ndarray,
    openCV_pose: np.ndarray,
    image_size: int,
    keep_inplane: bool = False,
    virtual_bbox_size: float = 0.3,
) -> np.ndarray:
    """The 3x3 src→dst homography the reference feeds to
    ``cv2.warpPerspective`` (``poses/utils.py:257-264``)."""
    corners3d = virtual_bbox_corners(openCV_pose, virtual_bbox_size, keep_inplane)
    K = np.asarray(intrinsic, dtype=np.float64)
    proj = corners3d @ K.T
    if np.any(np.abs(proj[:, 2]) < 1e-9):
        raise ValueError(
            "virtual bbox corner projects through the camera plane (object at or "
            f"behind the camera origin?): pose translation {np.asarray(openCV_pose)[:3, 3]}"
        )
    uv = proj[:, :2] / proj[:, 2:3]
    src2d = np.trunc(uv).astype(np.int32).astype(np.float32)  # reference int cast
    dst2d = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=np.float32) * image_size
    return get_perspective_transform(src2d, dst2d)


# ---------------------------------------------------------------------------
# host crop (reference-parity)
# ---------------------------------------------------------------------------


def _warp_host(img: np.ndarray, M: np.ndarray, image_size: int) -> np.ndarray:
    """cv2.warpPerspective where cv2 is importable, else the native warp
    (itself the torch warp, rounded back to uint8, where the native
    library cannot be built)."""
    try:
        import cv2
    except ImportError:
        from nope_tpu_torch import native

        return native.warp_perspective(img, M, image_size)
    return cv2.warpPerspective(img, M.astype(np.float64), (image_size, image_size))


def crop_frame(
    img,
    mask,
    intrinsic,
    openCV_pose,
    image_size: int,
    keep_inplane: bool = False,
    virtual_bbox_size: float = 0.3,
):
    """Reference-parity host crop (``poses/utils.py:204-272``).
    ``img`` is any HxWxC array-like; returns the warped crop (and warped
    mask when given)."""
    M = crop_homography(intrinsic, openCV_pose, image_size, keep_inplane, virtual_bbox_size)
    cropped = _warp_host(np.asarray(img), M, image_size)
    if mask is not None:
        return cropped, _warp_host(np.asarray(mask), M, image_size)
    return cropped


# ---------------------------------------------------------------------------
# tensor crop (any device)
# ---------------------------------------------------------------------------


def get_perspective_transform_torch(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Batched homography solve, in float64.  ``src``/``dst``: (..., 4, 2);
    returns (..., 3, 3) float64."""
    src, dst = src.double(), dst.double()
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    row_u = torch.stack([x, y, ones, zeros, zeros, zeros, -x * u, -y * u], dim=-1)
    row_v = torch.stack([zeros, zeros, zeros, x, y, ones, -x * v, -y * v], dim=-1)
    A = torch.cat([row_u, row_v], dim=-2)  # (..., 8, 8)
    b = torch.cat([u, v], dim=-1)[..., None]  # (..., 8, 1)
    h = torch.linalg.solve(A, b)[..., 0]
    return torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(*h.shape[:-1], 3, 3)


def _invert_3x3(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) inverse by the adjugate, elementwise (no solver launch)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                      f * g - d * i, a * i - c * g, c * d - a * f,
                      d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    det = a * co[..., 0] + b * co[..., 3] + c * co[..., 6]
    return (co / det[..., None]).reshape(m.shape)


def warp_perspective_torch(img: torch.Tensor, M: torch.Tensor, image_size: int) -> torch.Tensor:
    """dst(x, y) = src(M⁻¹ · (x, y, 1)) with bilinear sampling and zero
    border: the semantics of ``cv2.warpPerspective(..., INTER_LINEAR)``.

    ``img``: (H, W) or (H, W, C) with ``M`` (3, 3), or a batch (B, H, W)
    or (B, H, W, C) with ``M`` (B, 3, 3); float32 out, on ``img``'s device.
    M is inverted in float64; the projective transform is elementwise in
    float32, as the JAX package's comment asks (a matmul there would run
    in whatever precision the device's matmul defaults to)."""
    batched = M.dim() == 3
    if not batched:
        img, M = img[None], M[None]
    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., None]
    B, H, W, C = img.shape
    Minv = _invert_3x3(M.to(img.device, torch.float64)).float()
    ys, xs = torch.meshgrid(torch.arange(image_size, device=img.device, dtype=torch.float32),
                            torch.arange(image_size, device=img.device, dtype=torch.float32), indexing="ij")
    m = [Minv[:, r, c_][:, None, None] for r in range(3) for c_ in range(3)]
    w = m[6] * xs + m[7] * ys + m[8]
    u = (m[0] * xs + m[1] * ys + m[2]) / w
    v = (m[3] * xs + m[4] * ys + m[5]) / w
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    flat = img.float().reshape(B, H * W, C)

    def sample(vi, ui):
        valid = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        idx = (vi.clamp(0, H - 1).long() * W + ui.clamp(0, W - 1).long()).reshape(B, -1, 1)
        vals = torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(B, image_size, image_size, C)
        return vals * valid[..., None]

    top = sample(v0, u0) * (1 - du) + sample(v0, u0 + 1) * du
    bot = sample(v0 + 1, u0) * (1 - du) + sample(v0 + 1, u0 + 1) * du
    out = top * (1 - dv) + bot * dv
    if squeeze:
        out = out[..., 0]
    return out if batched else out[0]


def crop_frame_torch(
    img: torch.Tensor,
    intrinsic: torch.Tensor,
    openCV_pose: torch.Tensor,
    image_size: int,
    virtual_bbox_size: float = 0.3,
) -> torch.Tensor:
    """The non-inplane crop on tensors: corners, projection (with the
    reference's toward-zero truncation), homography solve and bilinear
    warp, on ``img``'s device.

    ``img``: (B, H, W, C) float; ``openCV_pose``: (B, 4, 4);
    ``intrinsic``: (3, 3) or (B, 3, 3).  Returns (B, S, S, C) float32."""
    dev = img.device
    pose = openCV_pose.to(dev, torch.float32)
    K = intrinsic.to(dev, torch.float32)
    origin = pose[:, :3, 3]
    up_hint = torch.cat([torch.tensor([0.0, 0.0, 6.0], device=dev) - origin, torch.ones_like(origin[:, :1])], -1)
    # the 4x4 product elementwise: exact float32, whatever the matmul precision
    upV = (pose * up_hint[:, None, :]).sum(-1)[:, :3]
    right = torch.linalg.cross(origin, upV)
    upper = torch.linalg.cross(right, origin)
    norm_up = torch.linalg.vector_norm(upper, dim=-1, keepdim=True)
    norm_r = torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    # the host's fallback where the up hint is parallel to the line of sight
    # (the JAX package's device crop has none and solves a singular system there)
    degenerate = (norm_up == 0) & (norm_r == 0)
    upper = torch.where(degenerate, torch.tensor([0.0, -1.0, 0.0], device=dev), upper)
    right = torch.where(degenerate, torch.tensor([1.0, 0.0, 0.0], device=dev), right)
    norm_up, norm_r = torch.where(degenerate, 1.0, norm_up), torch.where(degenerate, 1.0, norm_r)
    half = virtual_bbox_size / 2
    upper = upper * half / norm_up.clamp_min(1e-12)
    right = right * half / norm_r.clamp_min(1e-12)
    o, up, r = origin[:, None], upper[:, None], right[:, None]
    signs = torch.tensor([[1.0, -1.0], [-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]], device=dev)
    corners = o + signs[None, :, :1] * up + signs[None, :, 1:] * r  # (B, 4, 3)
    Kb = K.expand(len(pose), 3, 3)
    proj = (corners[:, :, None, :] * Kb[:, None, :, :]).sum(-1)  # corners · Kᵀ
    src2d = torch.trunc(proj[..., :2] / proj[..., 2:3])  # reference int32 cast
    dst2d = torch.tensor([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]], device=dev) * image_size
    M = get_perspective_transform_torch(src2d, dst2d.expand_as(src2d))
    return warp_perspective_torch(img, M, image_size)
