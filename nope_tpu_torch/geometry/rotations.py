"""Rotation-6d conversions (``nope_tpu/geometry/rotations.py``).

Elementwise math only, so the result does not depend on the matmul
precision settings of the device.
"""

from __future__ import annotations

import torch


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt the 6d representation (the first two *rows* of the
    matrix before orthonormalisation) into a rotation matrix."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=1e-12)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp(min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """First two rows of the rotation matrix, flattened."""
    return matrix[..., :2, :].reshape(*matrix.shape[:-2], 6)
