"""The comparison that decides ``correct``.

The configuration's reference side (for the pose-conditioned
configurations ``perfbench/sides/pose_conditional.py``) recomputes, for a
sample of the answers the window produced, what the program should have
answered; these judges reduce each pair to a few numbers that the cell's
limits hold:

- ``sim_ratio``: the widest gap between a served similarity row and the
  reference's, over the widest gap that the configuration's stated
  precision (bfloat16: the reference's modules and inputs cast to it)
  makes on the same row; a seed whose weights amplify rounding amplifies
  both, so the ratio holds steady where a gap alone swings;
- ``geo_cos``: the widest gap between the cosines of the program's
  geodesic errors of its top-k and of the reference metric's on the same
  top-k, which the program's own similarity row decides (cosines, since
  a float32 arccos near 0 or 180 degrees rounds to hundredths of a
  degree);
- ``loss_rel``: the evaluation step's float32 loss against the
  reference's, relative;
- ``rot_err``: the widest gap between a served rotation (absolute and
  relative to the reference's) and the grid's, on the top-k of the
  served similarity row.

The control, the reference one precision lower in the program's place,
goes through the same judges.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import task as ref


def sim_ratio(sim: np.ndarray, ref_sim: np.ndarray, stated_sim: np.ndarray) -> float:
    """The widest gap of one served row from the reference's, over the
    widest gap of the reference at the stated precision on the same row."""
    return float(np.max(np.abs(sim - ref_sim))) / float(np.max(np.abs(stated_sim - ref_sim)))


def geo_gap(sim: np.ndarray, errors: np.ndarray, grid: np.ndarray, query_pose: np.ndarray, symmetry: int,
            k: int) -> float:
    """The widest gap between the cosines of the program's top-k errors and
    of the reference metric's on the top-k of the program's own row."""
    idx = ref.top_k(torch.from_numpy(sim), k).numpy()
    want = ref.geodesic_error_deg(torch.from_numpy(grid[idx]).double(),
                                  torch.from_numpy(np.broadcast_to(query_pose, (k, 3, 3)).copy()).double(),
                                  torch.full((k,), int(symmetry)))
    return float(np.max(np.abs(np.cos(np.deg2rad(errors.astype(np.float64))) - np.cos(np.deg2rad(want.numpy())))))


def control_errors(side: Reference, sim: np.ndarray, grid: np.ndarray, query_pose: np.ndarray, symmetry: int,
                   k: int) -> np.ndarray:
    """What a side in the program's place answers for one row: the
    geodesic errors of its top-k, on its own rotations."""
    idx = ref.top_k(torch.from_numpy(sim), k).numpy()
    pred = torch.from_numpy(side.rotations(grid[idx]))
    gt = torch.from_numpy(side.rotations(np.broadcast_to(query_pose, (k, 3, 3)).copy()))
    return ref.geodesic_error_deg(pred, gt, torch.full((k,), int(symmetry))).numpy()


def worst(readings: list) -> dict:
    """The largest reading of each number over the sampled answers."""
    out = {}
    for r in readings:
        for name, v in r.items():
            out[name] = max(out.get(name, 0.0), v) if np.isfinite(v) else float("inf")
    return out


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number within its limit."""
    rows = [(name, readings.get(name, float("inf")), limit) for name, limit in limits.items()]
    return all(v <= limit for _, v, limit in rows), rows
