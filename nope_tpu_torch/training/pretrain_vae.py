"""First-stage (VAE) pretraining (``nope_tpu/training/pretrain_vae.py``).

For domains without a pretrained codec: reconstruction of the decoded
posterior sample plus ``kl_weight`` × the KL against N(0, 1), with AdamW.
The posterior sample's noise comes from an explicit ``torch.Generator``
(or is handed in)::

    vae = StableDiffusionVAE().to(device)
    state = create_vae_pretrain_state(vae, lr=2e-4, seed=2022)
    step = make_vae_pretrain_step()
    for images in loader:                   # (B, H, W, 3) in [-1, 1] or uint8
        state, metrics = step(state, images)
    # state.vae's weights: the frozen encoder of training (cli.train)

The VAE is plain PyTorch: no kernel of the port runs here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nope_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_mean_
from nope_tpu_torch.training.train_state import device_batch


@dataclasses.dataclass
class VAEPretrainState:
    step: int
    vae: nn.Module
    opt: torch.optim.Optimizer
    generator: torch.Generator


def create_vae_pretrain_state(vae: nn.Module, lr: float = 2e-4, seed: int = 0) -> VAEPretrainState:
    """AdamW as optax's ``adamw(lr)`` (weight decay 1e-4) over the VAE's
    parameters, and the sampling generator on the VAE's device."""
    device = next(vae.parameters()).device
    opt = torch.optim.AdamW(vae.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
                            foreach=True)
    return VAEPretrainState(0, vae.requires_grad_(True), opt, torch.Generator(device).manual_seed(seed))


class _Reconstruct(nn.Module):
    """encode → posterior sample → decode, as one forward (so bfloat16
    copies of the VAE's parameters can stand in for its own)."""

    def __init__(self, vae: nn.Module):
        super().__init__()
        self.vae = vae

    def forward(self, images, noise, generator, part: int = 0, parts: int = 1):
        dist = self.vae.encode(images)
        if noise is None:
            b = dist.mean.shape[0]
            noise = torch.randn((parts * b,) + tuple(dist.mean.shape[1:]), generator=generator,
                                dtype=dist.mean.dtype, device=generator.device)[part * b:(part + 1) * b]
        z = dist.mean + dist.std * noise.to(dist.mean.device, dist.mean.dtype)
        return self.vae.decode(z), dist


def make_vae_pretrain_step(recon_loss: str = "l1", kl_weight: float = 1e-6, half_precision: bool = False,
                           mesh=None):
    """The pretrain step: ``(state, images, noise=None) → (state, metrics)``,
    the state updated in place; ``metrics``: loss, recon, kl (device
    tensors).  ``noise`` (the posterior sample's standard normal draw,
    the latent's shape) replaces the generator's draw.

    ``half_precision`` runs forward and backward in bfloat16 over the
    float32 weights, as the train step does (``train_state.
    make_train_step``); the loss compares with the float32 images.

    ``mesh`` makes it data-parallel over its data axis, as the train
    step: ``images`` are the rank's rows of the global batch, the
    gradients and metrics are averaged over the ranks, and the
    generator draws the whole batch's noise, of which the rank takes
    its rows (so D ranks on the parts of a batch take the step one
    process takes on the whole)."""
    if recon_loss not in ("l1", "l2"):
        raise ValueError(f"recon_loss must be 'l1' or 'l2', got {recon_loss!r}")
    group = None if mesh is None else mesh.group(DATA_AXIS)
    part, parts = (0, 1) if mesh is None else (mesh.index(DATA_AXIS), mesh.data)

    def pretrain_step(state: VAEPretrainState, images, noise: Optional[torch.Tensor] = None
                      ) -> Tuple[VAEPretrainState, Dict[str, torch.Tensor]]:
        images = device_batch(images, next(state.vae.parameters()).device)
        model = _Reconstruct(state.vae)
        state.opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            if half_precision:
                params = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
                recon, dist = torch.func.functional_call(
                    model, params, (images.to(torch.bfloat16), noise, state.generator, part, parts))
            else:
                recon, dist = model(images, noise, state.generator, part, parts)
            diff = recon.float() - images.float()
            rec = torch.mean(torch.abs(diff)) if recon_loss == "l1" else torch.mean(diff * diff)
            kl = torch.mean(dist.kl().float())
            loss = rec + kl_weight * kl
            loss.backward()
        metrics = torch.stack([loss.detach(), rec.detach(), kl.detach()])
        if group is not None:
            params = [p for p in state.vae.parameters() if p.requires_grad]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_mean_([p.grad for p in params], group)
            all_reduce_mean_([metrics], group)
        state.opt.step()
        state.step += 1
        return state, dict(zip(("loss", "recon", "kl"), metrics.unbind()))

    return pretrain_step
