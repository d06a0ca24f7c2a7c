"""Checkpoints: the trainer's save and resume, and the port's weights
in the reference's torch format.

:class:`CheckpointManager` (``nope_tpu/training/checkpoint.py:22-112``)
keeps the full train state, one ``torch.save`` file per step (state
dicts of the U-Net, the VAE, the optimizer with its schedule count and
skip-spike state, and optionally the EMA U-Net), written to a temporary
name and renamed, so a crash mid-save leaves no checkpoint behind.

The weights alone (:func:`save_reference_checkpoint`, the trainer's
``final_params`` and ``best`` exports, :func:`restore_params`) are the
file the reference trainer writes (and what
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
import re
from typing import List, Optional

import torch

from nope_tpu_torch.parallel.mesh import process_barrier, process_index

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


def atomic_save(obj, path: str) -> None:
    """``torch.save`` to a temporary name beside ``path``, then rename."""
    tmp = os.path.join(os.path.dirname(os.path.abspath(path)), f".{os.path.basename(path)}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_reference_checkpoint(path: str, unet_state_dict, vae_state_dict) -> None:
    """Write U-Net and VAE state dicts (the port's key names) as a
    reference-format checkpoint that :func:`restore_params` reads."""
    state = {UNET_PREFIX + k: v for k, v in unet_state_dict.items()}
    state.update({VAE_PREFIX + k: v for k, v in vae_state_dict.items()})
    atomic_save({"state_dict": state}, path)


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


class CheckpointManager:
    """Save and restore of the train state with the reference's cadence
    (a checkpoint every ``save_interval_steps`` optimizer steps; keep all,
    or the newest ``max_to_keep``), as the JAX package's orbax manager:
    a step that is not a multiple of the interval, or not past the
    newest checkpoint, is not saved unless forced.  Files are
    ``<directory>/ckpt_<step>.pt``; anything else there is ignored.  The
directory is shared by the ranks of a process group: rank 0 writes,
every rank reads."""

    _NAME = re.compile(r"^ckpt_(\d+)\.pt$")

    def __init__(self, directory: str, save_interval_steps: int = 100, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_interval_steps = int(save_interval_steps)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        steps = (self._NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in steps if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, force: bool = False, ema_params=None) -> bool:
        """Save ``state`` (a ``TrainState``) at ``step``; ``ema_params`` (the
        EMA U-Net) rides in the same file.  Returns whether it saved.

        Under a process group every rank calls it: each decides from the
        directory as it was before anyone writes, a ZeRO-1 optimizer's
        state is gathered onto rank 0, rank 0 writes, and every rank
        waits for the file before it goes on."""
        latest = self.latest_step()
        if not force and ((latest is not None and latest >= step) or step % self.save_interval_steps):
            return False
        process_barrier("checkpoint_listed")
        payload = {
            "step": int(state.step),
            "unet": state.unet.state_dict(),
            "vae": state.vae.state_dict(),
            "opt": state.opt.state_dict(),
        }
        if ema_params is not None:
            payload["ema"] = ema_params.state_dict()
        if process_index() == 0:
            atomic_save(payload, self._path(step))
            if self.max_to_keep is not None:
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(self._path(old))
        process_barrier("checkpoint_written")
        return True

    def _load(self, step: Optional[int]) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    @staticmethod
    @torch.no_grad()
    def _into(state, payload: dict):
        state.unet.load_state_dict(payload["unet"], strict=True)
        state.vae.load_state_dict(payload["vae"], strict=True)
        state.opt.load_state_dict(payload["opt"])
        state.step = int(payload["step"])
        return state

    def restore(self, state, step: Optional[int] = None):
        """Load the checkpoint at ``step`` (default: the newest) into
        ``state``'s modules and optimizer, in place, on their device; an
        EMA stream in the file is ignored.  Under a process group every
        rank reads the file (a ZeRO-1 optimizer keeps its part)."""
        return self._into(state, self._load(step))

    def restore_with_ema(self, state, ema_params, step: Optional[int] = None):
        """(state, ema_params) restored in place; ``(state, None)`` from a
        checkpoint saved without an EMA stream (the caller seeds one)."""
        payload = self._load(step)
        self._into(state, payload)
        if "ema" not in payload:
            return state, None
        with torch.no_grad():
            ema_params.load_state_dict(payload["ema"], strict=True)
        return state, ema_params

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open between saves."""
