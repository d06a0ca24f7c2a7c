"""Training CLI (``nope_tpu/cli/train.py``, the reference's ``train.py``)::

    python -m nope_tpu_torch.cli.train [--config cfg.yaml] [--max-steps N] \\
        [--device cuda] [key=value ...]

e.g.::

    python -m nope_tpu_torch.cli.train name_exp=run1 \\
        data.datasets.shapeNet.root_dir=/data/shapenet \\
        machine.batch_size=16 model.u_net.pretrained_path=unet.pth

Runs on the card unless ``--device cpu``.  Warm starts
(``use_pretrained``) read a reference-format U-Net state dict
(``model.u_net.pretrained_path``) and a diffusers VAE
(``model.encoder.pretrained_path``: a file, or a directory holding
``diffusion_pytorch_model.bin``); an orbax directory of the JAX package
is refused.  The run resumes from ``<save_dir>/checkpoints`` where a
checkpoint is, and ends by writing ``checkpoints/final_params.pth`` (and
``final_params_ema.pth`` with EMA on) in the reference format that
``training.checkpoint.restore_params`` reads.  One process on one
device: a multi-process launch, ``machine.zero1`` and ``machine.mesh_*``
come with ROADMAP queue 1 item 12.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

#: diffusers<=0.14 attention names of the VAE's mid blocks → today's
_OLD_VAE_ATTN = {".query.": ".to_q.", ".key.": ".to_k.", ".value.": ".to_v.", ".proj_attn.": ".to_out.0."}


def _load_torch_file(path: str) -> dict:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?): the port warm-starts from "
            "reference-format torch files only (a U-Net state dict, a diffusers VAE file or directory)")
    return torch.load(path, map_location="cpu", weights_only=True)


def diffusers_vae_state_dict(sd: dict) -> dict:
    """A diffusers ``AutoencoderKL`` state dict in the port's VAE names:
    the pre-0.15 attention names (``query``/``key``/``value``/
    ``proj_attn``, 1x1-conv shaped) and LDM's ``nin_shortcut`` renamed, as
    the JAX package's ``port_sd_vae`` reads them."""
    out = {}
    for key, value in sd.items():
        if ".attentions." in key:
            for old, new in _OLD_VAE_ATTN.items():
                if old in key:
                    key = key.replace(old, new)
                    if value.dim() == 4:  # a 1x1 conv's weight as a linear's
                        value = value[:, :, 0, 0]
        out[key.replace(".nin_shortcut.", ".conv_shortcut.")] = value
    return out


@torch.no_grad()
def _maybe_warm_start(task, cfg) -> None:
    """Load pretrained U-Net / VAE weights into ``task`` in place
    (``train.py:47-60``).  The U-Net file is a bare state dict of the
    reference's U-Net (its VAE keys and the unused ``final_conv.0.mlp``
    are dropped); the VAE is a diffusers file, or a directory holding
    ``diffusion_pytorch_model.bin``."""
    from nope_tpu_torch.training.checkpoint import UNET_PREFIX, split_state_dict

    unet_path = cfg.model.u_net.pretrained_path
    if cfg.use_pretrained and unet_path:
        unet, _ = split_state_dict({UNET_PREFIX + k: v for k, v in _load_torch_file(unet_path).items()})
        task.unet.load_state_dict(unet, strict=True)
        logging.info("warm-started U-Net from %s", unet_path)
    enc_path = cfg.model.encoder.pretrained_path
    if cfg.use_pretrained and enc_path and cfg.model.encoder.kind == "vae":
        diffusers_bin = os.path.join(enc_path, "diffusion_pytorch_model.bin")
        sd = _load_torch_file(diffusers_bin if os.path.isfile(diffusers_bin) else enc_path)
        task.vae.load_state_dict(diffusers_vae_state_dict(sd), strict=True)
        logging.info("loaded frozen encoder from %s", enc_path)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --device cpu to run on the CPU")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("a multi-process launch comes with parallel/ (ROADMAP queue 1 item 12)")

    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.data.builder import build_train_loaders, build_val_loaders
    from nope_tpu_torch.evaluation.geodesic import evaluate_geodesic
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask
    from nope_tpu_torch.training.checkpoint import save_reference_checkpoint
    from nope_tpu_torch.training.trainer import Trainer

    cfg = load_config(args.config, args.overrides)
    os.makedirs(cfg.save_dir, exist_ok=True)
    logging.info("experiment %s -> %s", cfg.name_exp, cfg.save_dir)

    task = build_task(cfg.model, device, torch.Generator().manual_seed(cfg.trainer.seed))
    # before the resume, which then restores over the warm start
    _maybe_warm_start(task, cfg)
    train_loaders = build_train_loaders(cfg)
    val_loaders = build_val_loaders(cfg)

    def val_fn(state):
        val_task = PoseConditionalTask(state.unet, state.vae, task.config)
        scores = {}
        for name, loader in val_loaders.items():
            s = evaluate_geodesic(val_task, loader, tag=name, max_batches=8)
            scores.update({f"{name}/{k}": v for k, v in s.items()})
        return scores

    trainer = Trainer(cfg, task, train_loaders, val_fn=val_fn)
    state = trainer.fit(trainer.init_state(), max_steps=args.max_steps)

    # params-only exports, what evaluation and serving load (restore_params)
    final = os.path.join(cfg.save_dir, "checkpoints", "final_params.pth")
    save_reference_checkpoint(final, state.unet.state_dict(), state.vae.state_dict())
    logging.info("final params -> %s", final)
    if trainer.ema_params is not None:
        ema = os.path.join(cfg.save_dir, "checkpoints", "final_params_ema.pth")
        save_reference_checkpoint(ema, trainer.ema_params.state_dict(), state.vae.state_dict())
        logging.info("final EMA params -> %s", ema)
    trainer.logger.close()
    logging.info("training done")
    return state, trainer


if __name__ == "__main__":
    main()
