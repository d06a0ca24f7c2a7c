"""Geodesic evaluation harness (``nope_tpu/evaluation/geodesic.py``).

Host-side loop around :meth:`PoseConditionalTask.eval_geodesic_step`:
iterate a loader of numpy dict batches, aggregate symmetry-aware
accuracy at 15° and 30° and lower medians over all images, and
optionally dump per-batch predictions as ``.npz`` like the reference
(``model.py:361-376``).

The cross-process merge of the JAX package comes with ``parallel/``
(ROADMAP queue 1 item 12): until then an initialised
``torch.distributed`` group of more than one rank with
``sync_processes`` raises rather than scoring one rank's shard.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch


def _world() -> tuple:
    """(rank, world size) of an initialised ``torch.distributed`` group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The numeric arrays the eval step reads, on ``device`` (floats as
    float32); ``gt_templates`` is a host-side panel bank the step never
    reads."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype.kind in "fiub" and k != "gt_templates":
            arr = v.astype(np.float32) if v.dtype.kind == "f" else v
            out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def _pad_to(batch: Dict[str, np.ndarray], valid: int, steady: int) -> Dict[str, np.ndarray]:
    """Repeat the last item of every per-item array up to ``steady`` rows."""
    def pad(v):
        if np.ndim(v) >= 1 and len(v) == valid:
            return np.concatenate([v, np.repeat(v[-1:], steady - valid, axis=0)], axis=0)
        return v
    return {k: pad(v) for k, v in batch.items()}


def _save_panel(batch, out, valid: int, save_dir: str, tag: str, rank: int) -> None:
    """The retrieval panel of the first batch (``model.py:325-351``),
    and its text-labelled variant where matplotlib is installed."""
    from nope_tpu_torch.utils.visualization import draw_grid_text, save_image_grid, unnormalize

    top1 = out["nearest_idx"][:valid, 0]
    retrieved = batch["gt_templates"][np.arange(len(top1)), top1]
    save_image_grid(
        [unnormalize(batch["reference"][:8]), unnormalize(batch["query"][:8]), unnormalize(retrieved[:8])],
        os.path.join(save_dir, f"retrieved_{tag}_rank{rank}.png"),
    )
    try:
        n_show = min(4, valid)
        top1_sim = np.take_along_axis(out["similarity"][:n_show], top1[:n_show, None], axis=1)
        panel = np.stack([
            unnormalize(batch["query"][:n_show]),
            unnormalize(batch["reference"][:n_show]),
            np.zeros_like(unnormalize(retrieved[:n_show])),
            unnormalize(retrieved[:n_show]),
        ], axis=1)
        draw_grid_text(panel, top1_sim, os.path.join(save_dir, f"retrieved_text_{tag}_rank{rank}.png"))
    except ImportError:
        pass


def evaluate_geodesic(
    task,
    loader: Iterable[Dict[str, np.ndarray]],
    chunk_size: Optional[int] = None,
    save_dir: Optional[str] = None,
    tag: str = "eval",
    max_batches: Optional[int] = None,
    sync_processes: bool = True,
    refine_steps: int = 0,
) -> Dict[str, float]:
    """Run the geodesic eval over a loader of numpy dict batches; returns
    the scores over all images (top-1/3/5 accuracy at 15° and 30°, lower
    medians), the mean loss of the full batches, ``images_per_sec`` and
    ``num_images``.

    A ragged last batch is padded to the first batch's size by repeating
    its last item, and its outputs are trimmed; its loss is left out (a
    padded batch's mean would be skewed).  With ``half_precision_eval``
    the bfloat16 copy of the modules is made once here, for every batch.
    """
    if refine_steps:
        raise NotImplementedError("pose refinement is ROADMAP queue 1 item 10")
    rank, world = _world()
    if sync_processes and world > 1:
        raise NotImplementedError(
            f"merging the scores of {world} ranks comes with parallel/ (ROADMAP queue 1 item 12)")
    device = task.device
    infer_task = task.half() if task.config.half_precision_eval else task
    all_errors, losses = [], []
    steady_batch = None
    t0 = time.perf_counter()
    for i, batch in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        valid = len(batch["query"])
        if steady_batch is None:
            steady_batch = valid
        host = _pad_to(batch, valid, steady_batch) if valid < steady_batch else batch
        step = task.eval_geodesic_step(_to_device(host, device), chunk_size=chunk_size,
                                       infer_task=infer_task)
        out = {k: step[k].cpu().numpy() for k in ("similarity", "nearest_idx", "error_deg", "errors_topk")}
        all_errors.append(out["errors_topk"][:valid])
        if valid == steady_batch:
            losses.append(float(step["loss"]))
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            np.savez(
                os.path.join(save_dir, f"pred_{tag}_batch{i}_rank{rank}.npz"),
                similarity=out["similarity"][:valid],
                nearest_idx=out["nearest_idx"][:valid],
                error_deg=out["error_deg"][:valid],
                query_pose=np.asarray(batch["query_pose"]),
            )
            if i == 0 and "gt_templates" in batch:
                try:
                    _save_panel(batch, out, valid, save_dir, tag, rank)
                except Exception as e:  # the panel is a side product: report it, go on scoring
                    logging.warning("retrieval panel failed: %s", e)
        if i % 10 == 0 and losses:
            logging.info("eval %s batch %d: loss=%.4f", tag, i, losses[-1])

    k = int(task.config.retrieval_k)
    errors = np.concatenate(all_errors, axis=0) if all_errors else np.zeros((0, k))
    elapsed = time.perf_counter() - t0
    scores: Dict[str, float] = {
        "loss": float(np.sum(losses)) / len(losses) if losses else float("nan"),
        "images_per_sec": len(errors) / elapsed if elapsed > 0 else 0.0,
        "num_images": float(len(errors)),
    }
    if len(errors):
        for top in (1, 3, 5):
            if top > errors.shape[1]:
                continue
            best = np.min(errors[:, :top], axis=1)
            for threshold in (15.0, 30.0):
                scores[f"top{top}, accuracy_{int(threshold)}"] = float(np.mean(best <= threshold) * 100)
            scores[f"top{top}, median"] = float(np.sort(best)[(len(best) - 1) // 2])
    return scores


def evaluate_geodesic_full(task, loader_factory, categories, **kwargs) -> Dict[str, Dict[str, float]]:
    """One loader per category (BASELINE config 4): per-category scores
    and their mean."""
    results: Dict[str, Any] = {}
    for cat in categories:
        results[cat] = evaluate_geodesic(task, loader_factory(cat), tag=cat, **kwargs)
        logging.info("category %s: %s", cat, results[cat])
    keys = [k for k in next(iter(results.values())) if k.startswith("top")]
    results["mean"] = {k: float(np.mean([results[c][k] for c in categories])) for k in keys}
    return results
