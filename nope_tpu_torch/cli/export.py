"""Export CLI: reference torch weights → the one checkpoint the port's
serving and evaluation entry points read (``nope_tpu/cli/export.py``).

    python -m nope_tpu_torch.cli.export --out nope_flagship.pth \\
        --unet nope_unet.pth [--vae sd-vae/ or sd_vae.bin] \\
        [--config cfg.yaml] [model.u_net.u_net_dim=192 ...] [--device cuda]

``--unet`` is a reference-format U-Net checkpoint: a dict, its weights
under ``state_dict`` or at the top, their keys ``u_net.``-prefixed (the
reference's whole model; the encoder's keys there are not read) or
bare.  ``--vae`` is a diffusers ``AutoencoderKL`` state dict: a
directory holding ``diffusion_pytorch_model.bin``, or the ``.bin``
itself (attention weights under diffusers' old names, ``query`` /
``key`` / ``value`` / ``proj_attn``, or as 1x1 convolutions, are read
too).  The task is built from the config, as the JAX exporter builds
its params; the U-Net, and the VAE when given, load into it with
``strict=True`` (the reference's unused ``final_conv.0.mlp`` dropped),
which checks every name and shape as JAX's ``assert_tree_shapes_match``
does and raises ``ValueError`` naming the mismatch.  Without ``--vae``
the task's seeded VAE is written, as JAX writes its initialised params.

The one difference from the JAX exporter is the container: JAX writes
an orbax directory, the port one reference-format torch file
(``training.checkpoint.save_reference_checkpoint``), which
``restore_params``, ``restore_eval_params``, ``cli.infer``,
``cli.test_shapenet`` and ``cli.test_bop`` read.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict

import torch

#: diffusers' old attention names → the port's (the current diffusers names)
_OLD_ATTENTION_NAMES = {".query.": ".to_q.", ".key.": ".to_k.", ".value.": ".to_v.", ".proj_attn.": ".to_out.0."}


def _load(path: str) -> Dict[str, torch.Tensor]:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and isinstance(payload.get("state_dict"), dict):
        payload = payload["state_dict"]
    if not isinstance(payload, dict):
        raise ValueError(f"{path} holds no state dict")
    return {k: v for k, v in payload.items() if isinstance(v, torch.Tensor)}


def reference_unet_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The pose U-Net's weights of a reference-format checkpoint, in the
    port's names: the ``u_net.`` keys (not the encoder's under
    ``u_net.encoder.``) when there are any, else the whole dict; the dead
    ``final_conv.0.mlp`` dropped."""
    from nope_tpu_torch.training.checkpoint import DEAD_PREFIX, split_state_dict

    state = _load(path)
    unet, _ = split_state_dict(state)
    if not unet:
        unet = {k: v for k, v in state.items() if not k.startswith(DEAD_PREFIX)}
    return unet


def diffusers_vae_state_dict(path: str, target: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A diffusers VAE state dict (a directory with
    ``diffusion_pytorch_model.bin``, or the file) in the names and shapes
    of ``target`` (the port's VAE state dict): old attention names
    renamed, 1x1-conv attention weights taken as the Linear weights."""
    if os.path.isdir(path):
        path = os.path.join(path, "diffusion_pytorch_model.bin")
    out = {}
    for key, value in _load(path).items():
        for old, new in _OLD_ATTENTION_NAMES.items():
            if ".attentions." in key and old in key:
                key = key.replace(old, new)
        want = target.get(key)
        if (want is not None and value.dim() == 4 and want.dim() == 2 and tuple(value.shape[2:]) == (1, 1)
                and tuple(value.shape[:2]) == tuple(want.shape)):
            value = value[:, :, 0, 0]
        out[key] = value
    return out


def _load_strict(module: torch.nn.Module, state: Dict[str, torch.Tensor], what: str, path: str) -> None:
    try:
        module.load_state_dict(state, strict=True)
    except RuntimeError as e:
        raise ValueError(f"{what} of {path} does not match the configured model: {e}") from None


def main(argv=None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True, help="the checkpoint file to write")
    parser.add_argument("--unet", required=True, help="reference-format torch checkpoint (.pth)")
    parser.add_argument("--vae", default=None, help="diffusers VAE dir or .bin (optional)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (the default), cuda:<i> or cpu")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --device cpu to run on the CPU")

    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.training.checkpoint import save_reference_checkpoint

    cfg = load_config(args.config, args.overrides)
    task = build_task(cfg.model, device, torch.Generator().manual_seed(0))
    _load_strict(task.unet, reference_unet_state_dict(args.unet), "the U-Net", args.unet)
    logging.info("ported U-Net from %s", args.unet)
    if args.vae:
        _load_strict(task.vae, diffusers_vae_state_dict(args.vae, task.vae.state_dict()), "the VAE", args.vae)
        logging.info("ported VAE from %s", args.vae)

    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_reference_checkpoint(out, task.unet.state_dict(), task.vae.state_dict())
    print(f"exported params -> {out}")
    return out


if __name__ == "__main__":
    main()
