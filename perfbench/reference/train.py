"""The training step in plain PyTorch: the symmetrised l1 loss of
``reference/task.py`` over a frozen VAE's latents, and AdamW with a
linear warm-up, written out.  Frozen copies of the port's
``PoseConditionalTask.train_loss`` (both directions as one doubled U-Net
batch), ``training/train_state.device_batch`` (the uint8 wire normalised
as x/255·2−1) and ``training/optim`` (``torch.optim.AdamW``'s update, the
warm-up's learning rate read at the update count before the update).
"""

from __future__ import annotations

import copy

import torch

from perfbench.reference import task as ref

BLOCK = 64


def wire(x: torch.Tensor) -> torch.Tensor:
    """A batch array as the step takes it: uint8 normalised to [-1, 1]
    (x/255·2−1) in float32, float as it is."""
    return x.float() / 255.0 * 2.0 - 1.0 if x.dtype == torch.uint8 else x


@torch.no_grad()
def encode(vae, images: torch.Tensor) -> torch.Tensor:
    return torch.cat([vae.encode_image(images[i:i + BLOCK]) for i in range(0, len(images), BLOCK)])


def train_loss(unet, vae, batch: dict) -> torch.Tensor:
    """One dataset's symmetrised l1 loss: the U-Net predicts the query's
    latent from the reference's under ΔR and the reference's from the
    query's under ΔR⁻¹, as one doubled batch."""
    q_lat, r_lat = encode(vae, wire(batch["query"])), encode(vae, wire(batch["reference"]))
    pose = torch.cat([batch["relativeR"], batch["relativeR_inv"]]).float()
    pred = ref.predict_latent(unet, torch.cat([r_lat, q_lat]), pose)
    return ref.l1_loss(pred, torch.cat([q_lat, r_lat]))


def warmup_lr(count: int, base_lr: float, warm_up_steps: int) -> float:
    """The learning rate of update ``count`` (0 for the first) inside the
    linear warm-up."""
    if count >= warm_up_steps:
        raise ValueError("the reference follows steps inside the warm-up only")
    return base_lr * count / warm_up_steps


def adamw_steps(unet, vae, steps: list, optim: dict, device: torch.device) -> dict:
    """``len(steps)`` AdamW steps of a copy of ``unet`` (its weights the
    start), each over one step's batches ({dataset: batch}, the mean of the
    datasets' losses).  Returns the losses, the first gradient's norm a
    leaf and the norm of each leaf's change after the last step
    (float64, by parameter name)."""
    unet = copy.deepcopy(unet).requires_grad_(True)
    params = dict(unet.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = optim["betas"]
    losses, first = [], None
    for t, batches in enumerate(steps):
        for p in params.values():
            p.grad = None
        batches = {name: {k: x.to(device) for k, x in b.items()} for name, b in batches.items()}
        with torch.enable_grad():
            loss = sum(train_loss(unet, vae, b) for b in batches.values()) / len(batches)
            loss.backward()
        losses.append(float(loss.detach()))
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}
        if first is None:
            first = {n: float(torch.linalg.vector_norm(g.double())) for n, g in grads.items()}
        lr = warmup_lr(t, optim["lr"], optim["warm_up_steps"])
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n]
                p.mul_(1.0 - lr * optim["weight_decay"])
                m[n].lerp_(g, 1.0 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                c1, c2 = 1.0 - b1 ** (t + 1), 1.0 - b2 ** (t + 1)
                p.addcdiv_(m[n], (v[n].sqrt() / c2 ** 0.5).add_(optim["eps"]), value=-lr / c1)
    change = {n: float(torch.linalg.vector_norm((p.detach() - start[n]).double())) for n, p in params.items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
