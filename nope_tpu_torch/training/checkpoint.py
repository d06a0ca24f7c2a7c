"""Restore the port's weights from a reference-format torch checkpoint.

The file is what the reference trainer writes (and what
``nope_tpu/cli/test_shapenet.py`` reads): a dict whose ``state_dict``
holds the pose U-Net under ``u_net.`` and the SD-VAE under
``u_net.encoder.encoder.``.  The port's modules keep the reference's key
names, so both load with ``strict=True``; the reference's
``final_conv.0.mlp``, which its forward never calls and the port does
not build, is the one key set dropped.

An orbax directory (the JAX package's own checkpoints, which its
exporter ``python -m nope_tpu.cli.export`` writes from this very format)
is refused: reading one needs orbax and JAX.  Where those are installed,
``nope_tpu_torch.weights`` turns the restored JAX params into state
dicts and :func:`save_reference_checkpoint` writes them in this format.

:func:`restore_params` (the ``infer`` CLI's reader) takes whole
checkpoints only; :func:`restore_eval_params` (the ``test_shapenet``
CLI's) also takes a bare U-Net state dict and a file without VAE keys,
as the JAX package's evaluation CLI does.
"""

from __future__ import annotations

import os

import torch

UNET_PREFIX = "u_net."
VAE_PREFIX = "u_net.encoder.encoder."
#: the reference U-Net's unused ResnetBlock MLP
DEAD_PREFIX = "final_conv.0.mlp."


def split_state_dict(state_dict):
    """A reference-format ``state_dict`` → (U-Net state dict, VAE state
    dict) in the port's key names."""
    unet, vae = {}, {}
    for key, value in state_dict.items():
        if key.startswith(VAE_PREFIX):
            vae[key[len(VAE_PREFIX):]] = value
        elif key.startswith(UNET_PREFIX) and not key[len(UNET_PREFIX):].startswith(DEAD_PREFIX):
            unet[key[len(UNET_PREFIX):]] = value
    return unet, vae


def save_reference_checkpoint(path: str, unet_state_dict, vae_state_dict) -> None:
    """Write U-Net and VAE state dicts (the port's key names) as a
    reference-format checkpoint that :func:`restore_params` reads."""
    state = {UNET_PREFIX + k: v for k, v in unet_state_dict.items()}
    state.update({VAE_PREFIX + k: v for k, v in vae_state_dict.items()})
    torch.save({"state_dict": state}, path)


def _load_state_dict(path: str) -> dict:
    """The ``state_dict`` of a reference-format torch file, on the CPU."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?); the port reads the "
            "reference-format torch file that `python -m nope_tpu.cli.export` takes as its input. "
            "Where JAX and orbax are installed, write one from restored JAX params with "
            "nope_tpu_torch.weights and nope_tpu_torch.training.checkpoint.save_reference_checkpoint.")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or "state_dict" not in payload:
        raise ValueError(f"{path} holds no 'state_dict' (not a reference-format checkpoint)")
    return payload["state_dict"]


@torch.no_grad()
def restore_params(path: str, task) -> None:
    """Load the checkpoint at ``path`` into ``task``'s U-Net and VAE, in
    place, strictly, on their device and dtype."""
    unet, vae = split_state_dict(_load_state_dict(path))
    task.unet.load_state_dict(unet, strict=True)
    task.vae.load_state_dict(vae, strict=True)


@torch.no_grad()
def restore_eval_params(path: str, task) -> bool:
    """What the JAX package's evaluation CLI reads from a torch file
    (``nope_tpu/cli/test_shapenet.py:74-96``), into ``task`` in place:
    the U-Net from ``u_net.``-prefixed keys, or the whole ``state_dict``
    as a bare U-Net state dict when it has none; the VAE from its keys
    when there are any, else the task keeps its VAE.  Each module that
    is loaded is loaded strictly.  Returns whether the VAE was loaded."""
    state = _load_state_dict(path)
    unet, vae = split_state_dict(state)
    if not unet:
        unet = {k: v for k, v in state.items() if not k.startswith(DEAD_PREFIX)}
    task.unet.load_state_dict(unet, strict=True)
    if vae:
        task.vae.load_state_dict(vae, strict=True)
    return bool(vae)
