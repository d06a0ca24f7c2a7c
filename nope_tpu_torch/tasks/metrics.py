"""Symmetry-aware geodesic rotation error (``nope_tpu/tasks/metrics.py``).

The reference metric (``src/model/loss.py``), branchless over the batch:

- symmetry class 0: the SO(3) relative angle (pytorch3d semantics, the
  1e-4 arccos extrapolation bound);
- class 1 (two-fold): the smaller of the angles of R and Ry(180°)·R to
  the ground truth (``loss.py:29-49``);
- class 2 (circular, e.g. bottles): the angle between the OpenGL camera
  viewing axes of the two rotations (``loss.py:54-70``).

``GeodesicError`` reports accuracy at thresholds (×100) and the *lower*
median (torch's ``median``) for top-1 and, given top-k candidates,
top-3 and top-5.  All rotation math is elementwise float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from nope_tpu_torch.geometry.rotations import matmul3, so3_relative_angle
from nope_tpu_torch.geometry.transforms import convert_openCV_to_openGL_rotation

#: Ry(180°), the two-fold symmetry flip (``loss.py:11``)
_ROTY180 = ((-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, -1.0))


def _cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    num = torch.sum(a * b, dim=-1)
    den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)
    return num / torch.clamp(den, min=eps)


def so3_relative_angle_with_symmetry(pred: torch.Tensor, gt: torch.Tensor,
                                     symmetry: torch.Tensor) -> torch.Tensor:
    """(B,) rotation error in radians of (B, 3, 3) rotations; ``symmetry``
    (B,) in {0, 1, 2}.  Every variant is computed for the whole batch and
    selected per element."""
    pred = pred.to(torch.promote_types(pred.dtype, torch.float32))
    gt = gt.to(pred.dtype)
    symmetry = symmetry.reshape(-1).to(torch.int32)

    err_plain = so3_relative_angle(pred, gt, eps=1e-2)
    roty = pred.new_tensor(_ROTY180).expand_as(pred)
    err_two = torch.minimum(err_plain, so3_relative_angle(matmul3(roty, pred), gt, eps=1e-2))

    # circular: object R → camera R (inverse = transpose) → OpenGL; only
    # the viewing axes are compared, so the in-plane part drops out
    pred_gl = convert_openCV_to_openGL_rotation(pred.transpose(-1, -2))
    gt_gl = convert_openCV_to_openGL_rotation(gt.transpose(-1, -2))
    cos_sym = _cosine_similarity(pred_gl[:, 2, :3], gt_gl[:, 2, :3])
    err_circle = torch.acos(torch.clamp(cos_sym, -1.0, 1.0))

    return torch.where(symmetry == 1, err_two, torch.where(symmetry == 2, err_circle, err_plain))


def _median_lower(x: torch.Tensor) -> torch.Tensor:
    """The lower of the two middle elements (torch.median's choice)."""
    return torch.sort(x).values[(x.shape[0] - 1) // 2]


class GeodesicError:
    """Accuracy at thresholds and lower median (``loss.py:74-115``).

    Call with ``predR`` (B, 3, 3) for top-1, or (B, k, 3, 3) for the
    best of the first 1/3/5 candidates.  Returns ``(top1_error_deg,
    results)``."""

    def __init__(self, thresholds=(15,)):
        self.thresholds = tuple(thresholds)

    def topk_errors(self, predR: torch.Tensor, gtR: torch.Tensor, symmetry: torch.Tensor) -> torch.Tensor:
        """(B, k) per-candidate errors in degrees."""
        b, k = predR.shape[:2]
        flat = predR.reshape(b * k, 3, 3)
        gt_rep = gtR[:, None].expand(b, k, 3, 3).reshape(b * k, 3, 3)
        sym_rep = symmetry.reshape(-1)[:, None].expand(b, k).reshape(-1)
        return torch.rad2deg(so3_relative_angle_with_symmetry(flat, gt_rep, sym_rep)).reshape(b, k)

    def _scores(self, error: torch.Tensor, name: str) -> Dict[str, torch.Tensor]:
        out = {f"{name}, accuracy_{t}": torch.mean((error <= t).float()) * 100 for t in self.thresholds}
        out[f"{name}, median"] = _median_lower(error)
        return out

    def __call__(self, predR: torch.Tensor, gtR: torch.Tensor,
                 symmetry: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        symmetry = symmetry.reshape(-1)
        if predR.dim() == 3:
            error = torch.rad2deg(so3_relative_angle_with_symmetry(predR, gtR, symmetry))
            return error, self._scores(error, "top1")
        errors = self.topk_errors(predR, gtR, symmetry)
        results: Dict[str, torch.Tensor] = {}
        for idx_k in (0, 2, 4):
            if idx_k < errors.shape[1]:
                results.update(self._scores(errors[:, :idx_k + 1].amin(1), f"top{idx_k + 1}"))
        return errors[:, 0], results
