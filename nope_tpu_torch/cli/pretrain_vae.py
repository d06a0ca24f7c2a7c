"""First-stage (VAE) pretraining CLI (``nope_tpu/cli/pretrain_vae.py``).

Trains the SD-VAE on the experiment's own training images (query and
reference of each dataset's batch, datasets in turn) and writes its
state dict (diffusers names) to ``--out``, a torch file that
``cli.train`` reads as ``model.encoder.pretrained_path``::

    python -m nope_tpu_torch.cli.pretrain_vae --steps 20000 --out ckpts/vae.bin \\
        [--device cuda] data.datasets.shapeNet.root_dir=/data/nope/shapeNet

On the card unless ``--device cpu``.  The destination is checked before
any training; ``--save-every`` re-saves the weights periodically.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--steps", type=int, default=20000)
    parser.add_argument("--out", required=True, help="output torch file (the VAE's state dict)")
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--recon-loss", default="l1", choices=("l1", "l2"))
    parser.add_argument("--kl-weight", type=float, default=1e-6)
    parser.add_argument("--half-precision", action="store_true")
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument("--save-every", type=int, default=1000,
                        help="periodic re-save interval (0 = only at the end)")
    parser.add_argument("--overwrite", action="store_true", help="replace an existing --out")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    out = os.path.abspath(args.out)
    if os.path.exists(out) and not args.overwrite:
        # fail before training, not after a long run
        parser.error(f"--out {out} already exists (pass --overwrite to replace)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --device cpu to run on the CPU")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("a multi-process launch comes with parallel/ (ROADMAP queue 1 item 12)")

    logging.basicConfig(level=logging.INFO)
    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.data.builder import build_train_loaders
    from nope_tpu_torch.data.pipeline import CombinedLoader, device_prefetch
    from nope_tpu_torch.models.factory import build_vae
    from nope_tpu_torch.training.checkpoint import atomic_save
    from nope_tpu_torch.training.pretrain_vae import create_vae_pretrain_state, make_vae_pretrain_step
    from nope_tpu_torch.training.trainer import check_one_device

    cfg = load_config(args.config, args.overrides)
    if cfg.model.encoder.kind != "vae":
        parser.error(f"pretrain_vae requires model.encoder.kind=vae (got {cfg.model.encoder.kind!r})")
    check_one_device(cfg.machine)
    vae = build_vae(cfg.model.encoder, torch.Generator().manual_seed(cfg.trainer.seed), device)
    combined = CombinedLoader(build_train_loaders(cfg))
    state = create_vae_pretrain_state(vae, lr=args.lr, seed=cfg.trainer.seed)
    step_fn = make_vae_pretrain_step(recon_loss=args.recon_loss, kl_weight=args.kl_weight,
                                     half_precision=args.half_precision)

    def image_batches():
        # one step per dataset batch (datasets may differ in image size)
        while True:
            for batches in combined:
                for b in batches.values():
                    yield np.concatenate([np.asarray(b["query"]), np.asarray(b["reference"])])

    def save():
        atomic_save(state.vae.state_dict(), out)

    t0 = time.perf_counter()
    for images in device_prefetch(image_batches(), device, depth=2):
        if state.step >= args.steps:
            break
        state, metrics = step_fn(state, images)
        if state.step % args.log_every == 0 or state.step == args.steps:
            logging.info("step %d/%d recon=%.4f kl=%.1f (%.2f s/step)", state.step, args.steps,
                         float(metrics["recon"]), float(metrics["kl"]), (time.perf_counter() - t0) / state.step)
        if args.save_every and state.step % args.save_every == 0 and state.step < args.steps:
            save()
            logging.info("periodic save at step %d -> %s", state.step, out)
    save()
    logging.info("VAE weights written to %s", out)
    return state


if __name__ == "__main__":
    main()
