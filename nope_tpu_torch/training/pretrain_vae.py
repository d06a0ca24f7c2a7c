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

    def forward(self, images, noise, generator):
        dist = self.vae.encode(images)
        if noise is None:
            noise = torch.randn(dist.mean.shape, generator=generator, dtype=dist.mean.dtype,
                                device=generator.device)
        z = dist.mean + dist.std * noise.to(dist.mean.device, dist.mean.dtype)
        return self.vae.decode(z), dist


def make_vae_pretrain_step(recon_loss: str = "l1", kl_weight: float = 1e-6, half_precision: bool = False):
    """The pretrain step: ``(state, images, noise=None) → (state, metrics)``,
    the state updated in place; ``metrics``: loss, recon, kl (device
    tensors).  ``noise`` (the posterior sample's standard normal draw,
    the latent's shape) replaces the generator's draw.

    ``half_precision`` runs forward and backward in bfloat16 over the
    float32 weights, as the train step does (``train_state.
    make_train_step``); the loss compares with the float32 images."""
    if recon_loss not in ("l1", "l2"):
        raise ValueError(f"recon_loss must be 'l1' or 'l2', got {recon_loss!r}")

    def pretrain_step(state: VAEPretrainState, images, noise: Optional[torch.Tensor] = None
                      ) -> Tuple[VAEPretrainState, Dict[str, torch.Tensor]]:
        images = device_batch(images, next(state.vae.parameters()).device)
        model = _Reconstruct(state.vae)
        state.opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            if half_precision:
                params = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
                recon, dist = torch.func.functional_call(
                    model, params, (images.to(torch.bfloat16), noise, state.generator))
            else:
                recon, dist = model(images, noise, state.generator)
            diff = recon.float() - images.float()
            rec = torch.mean(torch.abs(diff)) if recon_loss == "l1" else torch.mean(diff * diff)
            kl = torch.mean(dist.kl().float())
            loss = rec + kl_weight * kl
            loss.backward()
        state.opt.step()
        state.step += 1
        return state, {"loss": loss.detach(), "recon": rec.detach(), "kl": kl.detach()}

    return pretrain_step
