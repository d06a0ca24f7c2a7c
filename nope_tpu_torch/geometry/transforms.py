"""Pose algebra: the device halves on tensors and the host halves on numpy
(``nope_tpu/geometry/transforms.py``).

Device (torch, batched; sign flips and products are elementwise, so
they are exact float32 on every device whatever the TF32 setting):
``relative_rotation`` (JAX ``relative_rotation_jax``), ``opencv2opengl``
(``opencv2opengl_jax``), ``convert_openCV_to_openGL_rotation`` (the
same name) and ``inverse_transform`` (``inverse_transform_jax``).

Host (numpy, for the dataset readers, the grid search and offline
tools; JAX's numpy names, except the three whose names the torch
functions hold): ``opencv2opengl_numpy`` (JAX ``opencv2opengl``),
``inverse_transform_numpy`` (``inverse_transform``),
``relative_rotation_numpy`` (``relative_rotation``); and under JAX's own
names ``combine_R_and_T``, ``normalize``, ``look_at``,
``spherical_to_cartesian``, ``cartesian_to_spherical``, ``perspective``,
``geodesic_numpy``, ``extract_inplane_from_pose``,
``convert_inplane_to_rotation``, ``adding_inplane_to_pose`` and
``compute_inplane``.  scipy is imported by the in-plane functions that
need it, not here.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

# OpenCV camera (x right, y down, z forward) ↔ OpenGL camera
# (x right, y up, z backward): flip Y and Z.
_CV2GL_4 = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float64
)


# ---------------------------------------------------------------------------
# device (torch)
# ---------------------------------------------------------------------------


def relative_rotation(query_R: torch.Tensor, ref_R: torch.Tensor) -> torch.Tensor:
    """Batched ΔR = R_q · R_rᵀ (rotations: inverse == transpose)."""
    return (query_R[..., :, None, :] * ref_R[..., None, :, :]).sum(-1)


def opencv2opengl(cam_matrix_world: torch.Tensor) -> torch.Tensor:
    """diag(1, -1, -1, 1) @ T over a batch of 4x4 poses (row sign flips)."""
    return cam_matrix_world * cam_matrix_world.new_tensor([1.0, -1.0, -1.0, 1.0])[:, None]


def convert_openCV_to_openGL_rotation(openCV_R: torch.Tensor) -> torch.Tensor:
    """diag(1, -1, -1) @ R over a batch of 3x3 rotations."""
    return openCV_R[..., :3, :3] * openCV_R.new_tensor([1.0, -1.0, -1.0])[:, None]


def inverse_transform(trans: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of rigid 4x4 transforms: [Rᵀ | -Rᵀt; 0 0 0 1]."""
    rot = trans[..., :3, :3].transpose(-1, -2)
    t = -(rot * trans[..., None, :3, 3]).sum(-1)
    top = torch.cat((rot, t[..., :, None]), dim=-1)
    bottom = trans.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(*trans.shape[:-2], 1, 4)
    return torch.cat((top, bottom), dim=-2)


# ---------------------------------------------------------------------------
# host (numpy)
# ---------------------------------------------------------------------------


def opencv2opengl_numpy(cam_matrix_world: np.ndarray) -> np.ndarray:
    """Flip the Y/Z rows of a 4x4 (or a batch of 4x4) camera matrix.
    Involutive: also converts back."""
    transform = _CV2GL_4.astype(cam_matrix_world.dtype)
    return np.matmul(transform, cam_matrix_world)


def combine_R_and_T(R, T, scale_translation: float = 1.0) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = np.asarray(R, dtype=np.float64).reshape(3, 3)
    m[:3, 3] = np.asarray(T, dtype=np.float64).reshape(-1) * scale_translation
    return m


def inverse_transform_numpy(trans: np.ndarray) -> np.ndarray:
    """Invert a rigid 4x4 transform, or a batch of them, into float32."""
    trans = np.asarray(trans)
    if trans.ndim == 3:
        rot = np.swapaxes(trans[:, :3, :3], -1, -2)
        t = -np.einsum("bij,bj->bi", rot, trans[:, :3, 3])
        out = np.zeros_like(trans, dtype=np.float32)
        out[:, 3, 3] = 1.0
        out[:, :3, :3] = rot
        out[:, :3, 3] = t
        return out
    rot = trans[:3, :3].T
    t = -rot @ trans[:3, 3]
    out = np.zeros((4, 4), dtype=np.float32)
    out[3, 3] = 1.0
    out[:3, :3] = rot
    out[:3, 3] = t
    return out


def normalize(vec: np.ndarray) -> np.ndarray:
    return vec / np.linalg.norm(vec, axis=-1, keepdims=True)


def look_at(cam_location: np.ndarray, point: np.ndarray) -> np.ndarray:
    """OpenCV-convention camera-to-world look-at (z forward toward
    ``point``), with the reference's fallback for the up hint at the poles."""
    cam_location = np.asarray(cam_location, dtype=np.float64)
    point = np.asarray(point, dtype=np.float64)
    forward = normalize(point - cam_location)

    tmp = np.array([0.0, 0.0, -1.0])
    norm = min(
        np.min(np.linalg.norm(cam_location - tmp, axis=-1)),
        np.min(np.linalg.norm(cam_location + tmp, axis=-1)),
    )
    if norm < 1e-3:
        tmp = np.array([0.0, -1.0, 0.0])

    right = normalize(np.cross(tmp, forward))
    up = normalize(np.cross(forward, right))

    mat = np.stack((right, up, forward, cam_location), axis=-1)
    hom = np.array([[0.0, 0.0, 0.0, 1.0]])
    if mat.ndim > 2:
        hom = np.tile(hom, (mat.shape[0], 1, 1))
    return np.concatenate((mat, hom), axis=-2)


def spherical_to_cartesian(azimuth, elevation, radius):
    x = radius * np.sin(elevation) * np.cos(azimuth)
    y = radius * np.sin(elevation) * np.sin(azimuth)
    z = radius * np.cos(elevation)
    return np.stack((x, y, z), axis=-1)


def cartesian_to_spherical(x, y, z):
    r = np.sqrt(x**2 + y**2 + z**2)
    theta = np.arccos(z / r)
    phi = np.arctan2(y, x)
    return r, theta, phi


def perspective(K: np.ndarray, obj_pose: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Project 3D points through K under ``obj_pose``, truncated toward
    zero as the reference's integer cast does."""
    R, T = obj_pose[:3, :3], obj_pose[:3, 3]
    cam = pts @ R.T + T
    proj = cam @ K.T
    uv = proj[:, :2] / proj[:, 2:3]
    return np.trunc(uv).astype(np.float64)


def geodesic_numpy(R1: np.ndarray, R2: np.ndarray) -> float:
    theta = (np.trace(R2 @ R1.T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(theta, -1, 1))))


def extract_inplane_from_pose(pose: np.ndarray) -> float:
    """First euler angle of the extrinsic-zyx decomposition, in degrees."""
    from scipy.spatial.transform import Rotation

    return float(Rotation.from_matrix(pose).as_euler("zyx", degrees=True)[0])


def convert_inplane_to_rotation(inplane: float) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_euler("z", -inplane, degrees=True).as_matrix()


def adding_inplane_to_pose(pose: np.ndarray, inplane: float) -> np.ndarray:
    return convert_inplane_to_rotation(inplane) @ pose


def compute_inplane(
    rot_query_openCV: np.ndarray, rot_template_openCV: np.ndarray, warn_deg: float = 15.0
) -> float:
    """In-plane angle that maps the template rotation onto the query,
    with the reference's warning when the recovered pose is >= 15 deg off."""
    delta = rot_template_openCV @ rot_query_openCV.T
    inp = extract_inplane_from_pose(delta)
    recovered = convert_inplane_to_rotation(inp) @ rot_template_openCV
    err = geodesic_numpy(recovered, rot_query_openCV)
    if err >= warn_deg:
        logging.warning("recovered in-plane pose error >= %s deg: %s", warn_deg, err)
    return inp


def relative_rotation_numpy(query_pose: np.ndarray, ref_pose: np.ndarray) -> np.ndarray:
    """ΔR = R_query · R_ref⁻¹ of two poses (3x3 or 4x4)."""
    return query_pose[:3, :3] @ np.linalg.inv(ref_pose)[:3, :3]
