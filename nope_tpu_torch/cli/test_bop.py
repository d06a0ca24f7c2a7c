"""BOP / T-LESS VSD evaluation CLI (``nope_tpu/cli/test_bop.py``).

Unseen instances under real occlusion: every query of the ``tless``
dataset (``data.datasets.tless``) is scored against the bank of 341
templates (level 2, "upper") predicted from its own reference; the top-5
templates' rotations with the query's GT translation are rendered and
scored by BOP'19 VSD on the host, and the recall at 0.3 and the median
VSD of the top-1/3/5 go to stdout and ``<save_dir>/vsd_scores.json``::

    python -m nope_tpu_torch.cli.test_bop \\
        data.datasets.tless.root_dir=/data/tless \\
        data.datasets.tless.split=test_primesense \\
        model.checkpoint_path=nope.pth [--num-workers 8] \\
        [--renderer auto|pyrender|numpy] [--chunk-size 31] [--device cuda]

The device side runs in float32, as the JAX CLI computes (the task's
params uncast), on the card unless ``--device cpu``; ``--chunk-size``
streams the bank's U-Net sweep in chunks of templates (a divisor of
341).  The checkpoint is a reference-format torch file
(``training.checkpoint.restore_params``, which ``cli.export`` writes);
without one the weights are random (seed 0).  ``--num-workers`` > 1
renders over a ``spawn`` process pool; ``--renderer`` picks the host
renderer (``evaluation.vsd.make_renderer``; ``auto`` takes pyrender
where it runs, else the numpy rasteriser) and the CLI prints the one
it took.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--num-workers", type=int, default=0)
    parser.add_argument("--renderer", default="auto", choices=("auto", "pyrender", "numpy"),
                        help="depth backend: pyrender EGL or the numpy rasteriser")
    parser.add_argument("--chunk-size", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (the default), cuda:<i> or cpu")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --device cpu to run on the CPU")

    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.data.builder import build_dataset
    from nope_tpu_torch.data.pipeline import DataLoader
    from nope_tpu_torch.evaluation.vsd import build_vsd_frames, evaluate_vsd_batch, make_renderer
    from nope_tpu_torch.evaluation.vsd_metrics import vsd_scores
    from nope_tpu_torch.models.factory import build_task

    cfg = load_config(args.config, args.overrides)
    os.makedirs(cfg.save_dir, exist_ok=True)
    task = build_task(cfg.model, device, torch.Generator().manual_seed(0))
    if cfg.model.checkpoint_path:
        from nope_tpu_torch.training.checkpoint import restore_params

        restore_params(cfg.model.checkpoint_path, task)
        logging.info("loaded checkpoint %s", cfg.model.checkpoint_path)
    else:
        logging.warning("no checkpoint given: random weights (smoke mode)")

    dataset = build_dataset(cfg.data.datasets["tless"])
    cad_paths = {oid: info["cad_path"] for oid, info in dataset.cads.items()}
    if cad_paths:
        print(f"VSD renderer: {make_renderer(next(iter(cad_paths.values())), args.renderer).backend}")
    loader = DataLoader(
        dataset, batch_size=cfg.machine.batch_size, shuffle=False,
        num_workers=cfg.machine.num_workers, drop_last=False,
    )

    def on_device(x):
        return torch.from_numpy(np.asarray(x)).to(device)

    all_errors = []
    for i, batch in enumerate(loader):
        if args.max_batches is not None and i >= args.max_batches:
            break
        with torch.no_grad():
            bank = task.generate_template_bank(on_device(batch["reference"]), on_device(batch["all_relativeR"]),
                                               chunk_size=args.chunk_size)
            _, nearest = task.retrieval(on_device(batch["query"]), bank)
            del bank
        frames = build_vsd_frames(batch, nearest.cpu().numpy(), np.asarray(batch["template_poses"][0]), cad_paths)
        errors = evaluate_vsd_batch(frames, num_workers=args.num_workers, renderer_backend=args.renderer)
        all_errors.append(errors)
        logging.info("batch %d: mean top-1 vsd=%.3f", i, float(errors[:, 0].mean()))

    scores = vsd_scores(np.concatenate(all_errors, axis=0))
    out_path = os.path.join(cfg.save_dir, "vsd_scores.json")
    with open(out_path, "w") as f:
        json.dump(scores, f, indent=2)
    print(json.dumps(scores, indent=2))
    return scores


if __name__ == "__main__":
    main()
