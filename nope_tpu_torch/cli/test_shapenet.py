"""ShapeNet unseen-category evaluation CLI (``nope_tpu/cli/test_shapenet.py``).

The "novel categories" protocol: per unseen category, every query image
of a ShapeNet-layout root is scored against the template bank of its
own reference (bank generation, retrieval, symmetry-aware geodesic
error), on the card unless ``--device cpu``::

    python -m nope_tpu_torch.cli.test_shapenet \\
        data.datasets.shapeNet.root_dir=/data/shapenet \\
        [model.checkpoint_path=nope.pth] [--categories bottle,mug] \\
        [--max-batches N] [--chunk-size 31] [--refine-steps 24] [--device cuda]

``data.datasets.shapeNet.fast_evaluation=false`` selects the full
341-template protocol (stream it with ``--chunk-size``).  The checkpoint
is a reference-format torch file (``training.checkpoint.
restore_eval_params``); without one the weights are random (seed 0).
Per-category and mean top-1/3/5 accuracies at 15° and 30° and medians
go to stdout and ``<save_dir>/scores.json``, per-batch predictions to
``<save_dir>/predictions/pred_{category}_batch{i}_rank0.npz``, as the
JAX CLI writes them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

import torch


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--categories", default=None, help="comma-separated")
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--chunk-size", type=int, default=None)
    parser.add_argument("--mesh-data", type=int, default=None,
                        help="shard eval over a (data, template) mesh (not ported yet)")
    parser.add_argument("--mesh-template", type=int, default=1)
    parser.add_argument("--refine-steps", type=int, default=0,
                        help="continuous pose-refinement steps from the "
                             "retrieved top-1 (0 = grid-snapped, the "
                             "reference protocol); adds 'refined, *' scores")
    parser.add_argument("--refine-lr", type=float, default=2e-2)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --device cpu to run on the CPU")
    if args.mesh_data or args.mesh_template > 1:
        raise NotImplementedError("--mesh-data / --mesh-template: the sharded evaluation comes with "
                                  "parallel/ (ROADMAP queue 1 item 12)")

    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.data.builder import build_dataset
    from nope_tpu_torch.data.categories import TEST_CATEGORIES
    from nope_tpu_torch.data.pipeline import DataLoader
    from nope_tpu_torch.evaluation.geodesic import evaluate_geodesic_full
    from nope_tpu_torch.models.factory import build_task

    cfg = load_config(args.config, args.overrides)
    cfg.name_exp = cfg.name_exp or "test_shapeNet"
    os.makedirs(cfg.save_dir, exist_ok=True)

    task = build_task(cfg.model, device, torch.Generator().manual_seed(0))
    ckpt = cfg.model.checkpoint_path
    if ckpt:
        from nope_tpu_torch.training.checkpoint import restore_eval_params

        with_vae = restore_eval_params(ckpt, task)
        logging.info("loaded checkpoint %s (%s)", ckpt, "U-Net and VAE" if with_vae else "U-Net; VAE as built")
    else:
        logging.warning("no checkpoint given: random weights (smoke mode)")

    categories = args.categories.split(",") if args.categories else TEST_CATEGORIES
    base = cfg.data.datasets["shapeNet"]

    def loader_factory(category):
        return DataLoader(
            build_dataset(dataclasses.replace(base, split=category)),
            batch_size=cfg.machine.batch_size,
            shuffle=False,
            drop_last=False,  # the protocol scores every query image
            num_workers=cfg.machine.num_workers,
        )

    results = evaluate_geodesic_full(
        task,
        loader_factory,
        categories,
        chunk_size=args.chunk_size,
        max_batches=args.max_batches,
        save_dir=os.path.join(cfg.save_dir, "predictions"),
        refine_steps=args.refine_steps,
        refine_lr=args.refine_lr,
    )
    out_path = os.path.join(cfg.save_dir, "scores.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    logging.info("scores written to %s", out_path)
    return results


if __name__ == "__main__":
    main()
