"""Single-image inference CLI (``nope_tpu/cli/infer.py``).

One reference image of a novel object and query images → the relative
3D rotation of each query, through the serving engine
(:mod:`nope_tpu_torch.serving`), on the card unless ``--device cpu``::

    python -m nope_tpu_torch.cli.infer --reference ref.png \\
        --queries q1.png q2.png --checkpoint nope.pth \\
        [--fast] [--refine-steps 24] [--out poses.json] [--device cuda] \\
        [model.* overrides]

Images are RGB(A) files; RGBA is composited over black, as the training
data.  The checkpoint is a reference-format torch file
(:mod:`nope_tpu_torch.training.checkpoint`); without one the weights are
random (seed 0).  The JSON is the JAX CLI's: per query the top-k
template indices, relative rotations (3x3 and rotation-6d), template
rotations, the (N,) similarity, and with ``--refine-steps`` the refined
relative rotation.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def _composite_rgba_black(rgba: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 → (H, W, 3) uint8 over black: (rgb·α + 127) // 255."""
    alpha = rgba[..., 3:4].astype(np.uint16)
    return ((rgba[..., :3].astype(np.uint16) * alpha + 127) // 255).astype(np.uint8)


def _load_image(path: str, img_size: int) -> np.ndarray:
    """An image file → (img_size, img_size, 3) float32 in [-1, 1]."""
    from PIL import Image

    img = Image.open(path)
    # palette, LA and grayscale modes first become RGB(A)
    img = img.convert("RGBA" if "A" in img.mode or "transparency" in img.info else "RGB")
    arr = np.asarray(img)
    if arr.shape[2] == 4:
        arr = _composite_rgba_black(arr)
    img = Image.fromarray(arr).resize((img_size, img_size), Image.BILINEAR)
    return (np.asarray(img).astype(np.float32) / 255.0) * 2.0 - 1.0


def run(cfg, reference: np.ndarray, queries: np.ndarray, device: torch.device,
        checkpoint: Optional[str] = None, fast: bool = False, refine_steps: int = 0,
        names: Optional[Sequence[str]] = None) -> dict:
    """Register ``reference`` (H, W, 3) and estimate ``queries`` (B, H, W, 3)
    (uint8, or float in [-1, 1]) with the model of ``cfg`` (an
    ``ExperimentConfig``) on ``device``; returns the CLI's JSON payload.
    ``names`` label the queries (default: their indices)."""
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.serving import PoseEstimator

    task = build_task(cfg.model, device, torch.Generator().manual_seed(0))
    if checkpoint:
        from nope_tpu_torch.training.checkpoint import restore_params

        restore_params(checkpoint, task)
        logging.info("loaded %s", checkpoint)
    else:
        logging.warning("no checkpoint given: random weights (smoke mode)")
    est = PoseEstimator(task, fast_evaluation=fast)
    est.register_object("object", reference)
    result = est.estimate("object", queries, refine_steps=refine_steps)
    report = []
    for i in range(len(result.nearest_idx)):
        rel = result.relative_rotations[i]
        entry = {
            "query": names[i] if names is not None else i,
            "topk_template_idx": result.nearest_idx[i].tolist(),
            # ΔR taking the reference view to the query view
            "topk_relative_rotations": rel.tolist(),
            "topk_relative_rotation6d": rel[:, :2, :].reshape(len(rel), 6).tolist(),
            # the retrieved grid poses (absolute only if the object sat at
            # the registered reference pose)
            "topk_template_rotations": result.rotations[i].tolist(),
            "similarity": result.similarity[i].tolist(),
        }
        if result.refined_relative_rotation is not None:
            entry["refined_relative_rotation"] = result.refined_relative_rotation[i].tolist()
        report.append(entry)
    return {"num_templates": est.num_templates, "results": report}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser()
    parser.add_argument("--reference", required=True)
    parser.add_argument("--queries", nargs="+", required=True)
    parser.add_argument("--checkpoint", default=None, help="reference-format torch checkpoint (.pth)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--fast", action="store_true", help="26-template fast grid instead of 341")
    parser.add_argument("--refine-steps", type=int, default=0,
                        help="gradient pose-refinement steps from the retrieved top-1 (continuous ΔR)")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from nope_tpu_torch.configs import load_config

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --device cpu to run on the CPU")
    cfg = load_config(args.config, args.overrides)
    size = cfg.model.img_size
    payload = run(cfg, _load_image(args.reference, size), np.stack([_load_image(p, size) for p in args.queries]),
                  device, checkpoint=args.checkpoint, fast=args.fast, refine_steps=args.refine_steps,
                  names=args.queries)
    out = json.dumps(payload, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        logging.info("wrote %s", args.out)
    else:
        print(out)


if __name__ == "__main__":
    main()
