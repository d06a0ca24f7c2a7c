"""Pose algebra on the device (``nope_tpu/geometry/transforms.py``, the
device halves).  Sign flips and products are elementwise, so they are
exact float32 on every device whatever the TF32 setting."""

from __future__ import annotations

import torch


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
