"""The task's arithmetic in plain PyTorch: the L1 loss, the reference's
"l2" similarity, top-k, the symmetry-aware geodesic error and the
rotation helpers they need.  Frozen copies of the program's
``tasks/pose_conditional.py``, ``ops/similarity.py``, ``tasks/metrics.py``
and ``geometry/rotations.py`` (the plain versions), on NHWC latents.
"""

from __future__ import annotations

import torch

#: Ry(180°), the two-fold symmetry flip
_ROTY180 = ((-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, -1.0))


def predict_latent(unet, ref_latent: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """U-Net on NHWC latents: (B, h, w, C), (B, pose_dim) → (B, h, w, C)."""
    return unet(ref_latent.permute(0, 3, 1, 2), pose).permute(0, 2, 3, 1)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_similarity(query: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """The reference "l2": -sum_{h,w} sqrt(sum_c ((q - t)^2)^2), (B, h, w, C)
    x (B|1, N, h, w, C) → (B, N), in the inputs' dtype."""
    diff2 = torch.square(query[:, None] - bank)
    return -torch.sum(torch.sqrt(torch.sum(torch.square(diff2), dim=-1)), dim=(-2, -1))


def top_k(sim: torch.Tensor, k: int) -> torch.Tensor:
    """The k best indices, best first, ties in index order."""
    return torch.sort(sim, dim=-1, descending=True, stable=True).indices[..., :k]


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=1e-12)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.stack((b1, b2, torch.linalg.cross(b1, b2, dim=-1)), dim=-2)


def _acos_extrapolated(x: torch.Tensor, bound: float = 1e-4) -> torch.Tensor:
    """arccos, linearly extrapolated outside [-1 + bound, 1 - bound]
    (pytorch3d's ``acos_linear_extrapolation``)."""
    lo, hi = -1.0 + bound, 1.0 - bound
    t = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)  # noqa: E731
    slope = lambda v: -1.0 / torch.sqrt(1.0 - t(v) * t(v))  # noqa: E731
    mid = torch.acos(torch.clamp(x, lo, hi))
    above = torch.acos(t(hi)) + (x - hi) * slope(hi)
    below = torch.acos(t(lo)) + (x - lo) * slope(lo)
    return torch.where(x > hi, above, torch.where(x < lo, below, mid))


def relative_angle(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (radians) between batches of rotations."""
    r12 = r1 @ r2.transpose(-1, -2)
    return _acos_extrapolated((r12[..., 0, 0] + r12[..., 1, 1] + r12[..., 2, 2] - 1.0) * 0.5)


def geodesic_error_deg(pred: torch.Tensor, gt: torch.Tensor, symmetry: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) pred and gt, symmetry (B,) in {0, 1, 2} → (B,) degrees:
    class 0 the SO(3) angle, class 1 the smaller of R's and Ry(180°)·R's,
    class 2 the angle between the OpenGL viewing axes."""
    gt = gt.to(pred.dtype)
    plain = relative_angle(pred, gt)
    two = torch.minimum(plain, relative_angle(pred.new_tensor(_ROTY180) @ pred, gt))
    flip = pred.new_tensor([1.0, -1.0, -1.0])
    a, b = pred[..., :, 2] * flip[2], gt[..., :, 2] * flip[2]  # row 2 of diag(1,-1,-1)·Rᵀ
    cos = torch.sum(a * b, -1) / torch.clamp(torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1), min=1e-8)
    circle = torch.acos(torch.clamp(cos, -1.0, 1.0))
    sym = symmetry.reshape(-1)
    return torch.rad2deg(torch.where(sym == 1, two, torch.where(sym == 2, circle, plain)))
