"""Geodesic evaluation harness (``nope_tpu/evaluation/geodesic.py``).

Host-side loop around :meth:`PoseConditionalTask.eval_geodesic_step`:
iterate a loader of numpy dict batches, aggregate symmetry-aware
accuracy at 15° and 30° and lower medians over all images, and
optionally dump per-batch predictions as ``.npz`` like the reference
(``model.py:361-376``).

Under a process group, either each rank scores its own part of the
images and the scores are merged across the ranks
(``sync_processes``), or, with ``mesh``, every rank reads the whole
batch and the step runs over the mesh: the batch split over the data
axis, the template grid over the template axis (``parallel.eval``),
the rows gathered back onto every rank.
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from nope_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather,
    all_gather_host,
    all_reduce_mean_,
    check_template_divides,
    process_count,
    process_index,
    shard_eval_batch,
)
from nope_tpu_torch.utils import profiling


def _merge_across_processes(errors: np.ndarray, loss_sum: float, loss_count: int, k: int):
    """All-gather every rank's eval results so every rank computes the
    same global scores (the reference logs with ``sync_dist=True``,
    ``model.py:184-191``).  Ranks may hold different numbers of rows
    (disjoint loader parts, possibly none), so the rows are zero-padded
    to the largest count before the gather and sliced back by each
    rank's count: padding never passes for data, and a row that is
    legitimately NaN survives.  ``k`` columns on every rank."""
    counts = all_gather_host(np.asarray([errors.shape[0]], np.int64)).reshape(-1)
    max_n = max(int(counts.max()), 1)
    padded = np.zeros((max_n, k), dtype=np.float32)
    padded[: errors.shape[0]] = errors
    gathered = all_gather_host(padded)
    merged = np.concatenate([gathered[p, : counts[p]] for p in range(len(counts))], axis=0)
    loss_stats = all_gather_host(np.asarray([loss_sum, float(loss_count)], dtype=np.float64)).reshape(-1, 2)
    return merged, float(loss_stats[:, 0].sum()), int(loss_stats[:, 1].sum())


def _sharded_step(task, host: Dict[str, np.ndarray], mesh, chunk_size, refine_steps, refine_lr, infer_task):
    """The eval step over ``mesh``: this rank's rows of the whole batch
    (the data axis), its template group sweeping the grid (the template
    axis), then the rows gathered back and the scalars averaged over the
    data axis, so every rank holds the whole batch's outputs."""
    from nope_tpu_torch.parallel.eval import template_parallel_similarity

    check_template_divides("all_relativeR", np.shape(host["all_relativeR"])[1], mesh.template)
    local = shard_eval_batch(host, mesh, template_keys=())

    def similarity_fn(infer, q_lat, r_lat, all_rel):
        return template_parallel_similarity(infer, q_lat, r_lat, all_rel, mesh, chunk_size)

    out = task.eval_geodesic_step(_to_device(local, task.device), chunk_size=chunk_size, refine_steps=refine_steps,
                                  refine_lr=refine_lr, infer_task=infer_task, similarity_fn=similarity_fn)
    group = mesh.group(DATA_AXIS)
    scalars = [k for k, v in out.items() if v.dim() == 0]
    values = torch.stack([out[k].float() for k in scalars])
    all_reduce_mean_([values], group)
    merged = {k: all_gather(v, group, dim=0) for k, v in out.items() if v.dim() >= 1}
    merged.update(zip(scalars, values.unbind()))
    return merged


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


def _pulled(loader: Iterable[Dict[str, np.ndarray]]) -> Iterator[Dict[str, np.ndarray]]:
    """The loader's batches, each pull inside an ``eval.load`` span."""
    batches = iter(loader)
    end = object()
    for i in itertools.count():
        with profiling.span("eval.load", request=i):
            batch = next(batches, end)
        if batch is end:
            return
        yield batch


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
    mesh=None,
    sync_processes: bool = True,
    refine_steps: int = 0,
    refine_lr: float = 2e-2,
) -> Dict[str, float]:
    """Run the geodesic eval over a loader of numpy dict batches; returns
    the scores over all images (top-1/3/5 accuracy at 15° and 30°, lower
    medians), the mean loss of the full batches, ``images_per_sec`` and
    ``num_images``.  With ``refine_steps`` > 0 every top-1 pose is also
    refined (``eval_geodesic_step``), the dumps gain ``refined_R`` and
    ``refined_error_deg``, and the scores ``refined, accuracy_15``,
    ``refined, accuracy_30`` and ``refined, median``.

    A ragged last batch is padded to the first batch's size by repeating
    its last item, and its outputs are trimmed; its loss is left out (a
    padded batch's mean would be skewed).  With ``half_precision_eval``
    the bfloat16 copy of the modules is made once here, for every batch.

    With ``mesh`` (``parallel.mesh.Mesh``) every rank passes the whole
    batch and the step runs over the mesh (the steady batch a multiple
    of the data axis, the grid of the template axis); every rank then
    scores every image.  Without one, under a process group each rank
    scores its own part of the images and, with ``sync_processes``, the
    scores are the all-gathered global ones, the same on every rank
    (``num_images`` and ``images_per_sec`` too).  Dumps and panels are
    rank-suffixed.

    Spans (``utils.profiling``), each with the batch index as its
    request, and none around the loop, so that a pause between steps
    takes the name of its phase: ``eval.load`` (the loader's pull),
    ``eval.to_device`` (padding and, without ``mesh``, the host→device
    copy), ``eval.step`` (the step's host side) and ``eval.fetch`` (the
    read-back, the loss, dumps and bookkeeping), whose child
    ``eval.wait`` is the first read, which waits for the step's device
    work.
    """
    rank, world = process_index(), process_count()
    device = task.device
    infer_task = task.half() if task.config.half_precision_eval else task
    all_errors, all_refined, losses = [], [], []
    steady_batch = None
    t0 = time.perf_counter()
    for i, batch in enumerate(_pulled(loader)):
        if max_batches is not None and i >= max_batches:
            break
        valid = len(batch["query"])
        if steady_batch is None:
            steady_batch = valid
        with profiling.span("eval.to_device", request=i):
            host = _pad_to(batch, valid, steady_batch) if valid < steady_batch else batch
            on_device = _to_device(host, device) if mesh is None else None
        with profiling.span("eval.step", request=i):
            if mesh is None:
                step = task.eval_geodesic_step(on_device, chunk_size=chunk_size, refine_steps=refine_steps,
                                               refine_lr=refine_lr, infer_task=infer_task)
            else:
                step = _sharded_step(task, host, mesh, chunk_size, refine_steps, refine_lr, infer_task)
        keys = [k for k in ("similarity", "nearest_idx", "error_deg", "errors_topk", "refined_R",
                            "refined_error_deg") if k in step]
        with profiling.span("eval.fetch", request=i):
            with profiling.span("eval.wait", request=i):
                out = {keys[0]: step[keys[0]].cpu().numpy()}
            out.update((k, step[k].cpu().numpy()) for k in keys[1:])
            all_errors.append(out["errors_topk"][:valid])
            if refine_steps:
                all_refined.append(out["refined_error_deg"][:valid])
            if valid == steady_batch:
                losses.append(float(step["loss"]))
            if save_dir is not None:
                os.makedirs(save_dir, exist_ok=True)
                dump = {k: out[k][:valid] for k in ("similarity", "nearest_idx", "error_deg")}
                dump["query_pose"] = np.asarray(batch["query_pose"])
                if refine_steps:
                    dump.update(refined_R=out["refined_R"][:valid],
                                refined_error_deg=out["refined_error_deg"][:valid])
                np.savez(os.path.join(save_dir, f"pred_{tag}_batch{i}_rank{rank}.npz"), **dump)
                if i == 0 and "gt_templates" in batch:
                    try:
                        _save_panel(batch, out, valid, save_dir, tag, rank)
                    except Exception as e:  # the panel is a side product: report it, go on scoring
                        logging.warning("retrieval panel failed: %s", e)
            if i % 10 == 0 and losses:
                logging.info("eval %s batch %d: loss=%.4f", tag, i, losses[-1])

    k = int(task.config.retrieval_k)
    errors = np.concatenate(all_errors, axis=0) if all_errors else np.zeros((0, k))
    if refine_steps:
        refined = np.concatenate(all_refined) if all_refined else np.zeros((0,))
        # the refined column rides the top-k gather: one collective
        errors = np.concatenate([errors, refined[:, None]], axis=1)
    elapsed = time.perf_counter() - t0
    loss_sum, loss_count = float(np.sum(losses)), len(losses)
    if sync_processes and world > 1 and mesh is None:
        errors, loss_sum, loss_count = _merge_across_processes(errors.astype(np.float32), loss_sum, loss_count,
                                                               errors.shape[1])
    if refine_steps:
        errors, refined = errors[:, :k], errors[:, k]
    scores: Dict[str, float] = {
        "loss": loss_sum / loss_count if loss_count else float("nan"),
        # global after a merge: all ranks ran at once, so global images
        # over the local wall time is the aggregate rate
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
        if refine_steps:
            for threshold in (15.0, 30.0):
                scores[f"refined, accuracy_{int(threshold)}"] = float(np.mean(refined <= threshold) * 100)
            scores["refined, median"] = float(np.sort(refined)[(len(refined) - 1) // 2])
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
