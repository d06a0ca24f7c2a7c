"""BOP VSD metric math, numpy only (``nope_tpu/evaluation/vsd_metrics.py``).

The visible-surface-discrepancy pieces of bop_toolkit that the reference
vendors: depth → distance image, the GT and estimate visibility masks,
the BOP'19 per-pose VSD cost and the top-k recall/median summary.
Rendering is injected (:mod:`nope_tpu_torch.evaluation.vsd`), so this
module is tested without any renderer.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def depth_im_to_dist_im(depth_im: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Z-depth image → euclidean camera-ray distance image."""
    xs, ys = np.meshgrid(
        np.arange(depth_im.shape[1]), np.arange(depth_im.shape[0])
    )
    pre_xs = (xs - K[0, 2]) / np.float64(K[0, 0])
    pre_ys = (ys - K[1, 2]) / np.float64(K[1, 1])
    return np.sqrt(
        (pre_xs * depth_im) ** 2
        + (pre_ys * depth_im) ** 2
        + depth_im.astype(np.float64) ** 2
    )


def _estimate_visib_mask(
    d_test: np.ndarray, d_model: np.ndarray, delta: float, visib_mode: str = "bop19"
) -> np.ndarray:
    assert d_test.shape == d_model.shape
    d_diff = d_model.astype(np.float32) - d_test.astype(np.float32)
    if visib_mode == "bop18":
        valid = np.logical_and(d_test > 0, d_model > 0)
        return np.logical_and(d_diff <= delta, valid)
    if visib_mode == "bop19":
        # object treated as visible at pixels with missing depth
        return np.logical_and(
            np.logical_or(d_diff <= delta, d_test == 0), d_model > 0
        )
    raise ValueError(visib_mode)


def estimate_visib_mask_gt(d_test, d_gt, delta, visib_mode="bop19"):
    return _estimate_visib_mask(d_test, d_gt, delta, visib_mode)


def estimate_visib_mask_est(d_test, d_est, visib_gt, delta, visib_mode="bop19"):
    visib_est = _estimate_visib_mask(d_test, d_est, delta, visib_mode)
    return np.logical_or(visib_est, np.logical_and(visib_gt, d_est > 0))


def vsd_error_from_depths(
    depth_test: np.ndarray,
    depth_gt: np.ndarray,
    depth_est: np.ndarray,
    K: np.ndarray,
    delta: float = 15.0,
    tau: float = 20.0,
    cost_type: str = "step",
) -> float:
    """Single-pose BOP VSD error (``vsd.py:92-136`` semantics)."""
    dist_test = depth_im_to_dist_im(depth_test, K)
    dist_gt = depth_im_to_dist_im(depth_gt, K)
    dist_est = depth_im_to_dist_im(depth_est, K)

    visib_gt = estimate_visib_mask_gt(dist_test, dist_gt, delta)
    visib_est = estimate_visib_mask_est(dist_test, dist_est, visib_gt, delta)

    inter = np.logical_and(visib_gt, visib_est)
    union = np.logical_or(visib_gt, visib_est)
    union_count = int(union.sum())
    comp_count = union_count - int(inter.sum())
    if union_count == 0:
        return 1.0

    dists = np.abs(dist_gt[inter] - dist_est[inter])
    if cost_type == "step":
        costs = dists >= tau
    elif cost_type == "tlinear":
        costs = np.minimum(dists / tau, 1.0)
    else:
        raise ValueError(cost_type)
    return float((np.sum(costs) + comp_count) / float(union_count))


def vsd_scores(
    vsd_errors: np.ndarray,
    ks: Sequence[int] = (1, 3, 5),
    thresholds: Sequence[float] = (0.3,),
) -> dict:
    """Aggregate (num_frames, k_max) per-frame errors into the
    reference's reported top-k recall/median (``model.py:530-537``)."""
    out = {}
    for k in ks:
        best = np.min(vsd_errors[:, :k], axis=1)
        out[f"top {k}, vsd_median"] = float(np.median(best))
        for t in thresholds:
            out[f"top {k}, vsd_scores {t}"] = float(np.mean((best <= t) * 100.0))
    return out
