"""Pose algebra on the device (``nope_tpu/geometry/transforms.py``)."""

from __future__ import annotations

import torch


def relative_rotation(query_R: torch.Tensor, ref_R: torch.Tensor) -> torch.Tensor:
    """Batched ΔR = R_q · R_rᵀ (rotations: inverse == transpose).

    Written as a broadcast product and sum, so it is exact float32 on
    every device whatever the TF32 setting."""
    return (query_R[..., :, None, :] * ref_R[..., None, :, :]).sum(-1)
