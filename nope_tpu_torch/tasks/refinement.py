"""Continuous pose refinement by gradient descent through the U-Net
(``nope_tpu/tasks/refinement.py``).

Retrieval's answer is the nearest of N grid rotations.  Refinement takes
it as an initialisation: the 6-d rotation representation (the U-Net's
conditioning) is a free variable, and Adam minimises the latent distance
between the U-Net's prediction at that pose and the query's latent.  The
Gram-Schmidt inside ``rotation_6d_to_matrix`` maps every iterate to a
rotation, so no projection step is needed.  Each step costs one U-Net
forward and backward on the (B,) batch: on the card the forward runs the
K3 and K2 kernels, the backward recomputes their plain versions
(``ops.fused_resnet.fused_resnet_block``, ``ops.linear_attention.linear_attention``).

The gradient is taken with respect to the pose alone, as ``jax.grad``
takes it in the JAX package: the U-Net's parameters are out of the graph
while the loop runs (:func:`frozen` clears their ``requires_grad`` flags
and restores them after), so no weight gradient is computed and no
``.grad`` is written.

Adam is :func:`adam_update`, a plain function of tensors with
``optax.adam``'s defaults, so the loop stays a function of tensors with
no optimizer object.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Tuple

import torch
from torch import nn

from nope_tpu_torch.geometry.rotations import matrix_to_rotation_6d, rotation_6d_to_matrix

AdamState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (count, mu, nu)


def _per_sample_objective(name: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """(B, h, w, C) prediction vs target → (B,) distances (lower is better).

    "l2" (the default) is smooth and well conditioned; "l1" matches the
    training loss; "quirk" is the reference's retrieval metric
    −Σ_hw √Σ_c (q−t)⁴ negated into a distance, with 1e-12 inside the √
    (its gradient is unbounded at exact equality)."""
    dims = (1, 2, 3)
    if name == "l2":
        return lambda p, t: torch.mean(torch.square(p - t), dim=dims)
    if name == "l1":
        return lambda p, t: torch.mean(torch.abs(p - t), dim=dims)
    if name == "quirk":
        def quirk(p, t):
            per_channel = torch.sum(torch.square(torch.square(p - t)), dim=3)
            return torch.sum(torch.sqrt(per_channel + 1e-12), dim=(1, 2))

        return quirk
    raise ValueError(f"unknown refinement objective {name!r}")


def adam_init(x: torch.Tensor) -> AdamState:
    """Adam's state for ``x``: a step count and two zero moments."""
    return torch.zeros((), dtype=torch.float32, device=x.device), torch.zeros_like(x), torch.zeros_like(x)


def adam_update(grad: torch.Tensor, state: AdamState, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, eps_root: float = 0.0) -> Tuple[torch.Tensor, AdamState]:
    """One step of ``optax.adam(lr)``: returns (update, new state); the
    caller adds the update.  Bias-corrected moments, eps outside the √."""
    count, mu, nu = state
    mu = (1 - b1) * grad + b1 * mu
    nu = (1 - b2) * torch.square(grad) + b2 * nu
    count = count + 1
    mu_hat = mu / (1 - b1**count)
    nu_hat = nu / (1 - b2**count)
    return -lr * (mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)), (count, mu, nu)


@contextlib.contextmanager
def frozen(module: nn.Module) -> Iterator[None]:
    """``module``'s parameters out of the autograd graph: their
    ``requires_grad`` flags cleared, and restored on exit."""
    thawed = [p for p in module.parameters() if p.requires_grad]
    for p in thawed:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in thawed:
            p.requires_grad_(True)


def make_pose_refiner(task, steps: int = 24, lr: float = 2e-2, objective: str = "l2"):
    """Build ``refine(query_latent, reference_latent, init_R)``.

    ``init_R``: (B, 3, 3) initial rotations (typically the retrieved
    top-1 grid poses).  Returns ``(refined_R, distance)``: (B, 3, 3)
    rotations and the (B,) final latent distances, on the latents'
    device.  The U-Net runs in ``reference_latent``'s dtype; the pose,
    Adam's state and the objective are float32.  A sample keeps its
    refined pose only where the objective there is no larger than at its
    init (a NaN falls back to the init)."""
    if getattr(task.unet, "rot_representation_dim", 6) != 6:
        raise ValueError(
            "pose refinement optimises the 6d rotation representation; "
            f"this U-Net conditions on dim {task.unet.rot_representation_dim}"
        )
    dist_fn = _per_sample_objective(objective)

    def refine(query_latent: torch.Tensor, reference_latent: torch.Tensor,
               init_R: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        target = query_latent.float()
        in_dtype = reference_latent.dtype

        def distances(r6):
            pred = task.predict_latent(reference_latent, r6.to(in_dtype))
            return dist_fn(pred.float(), target)

        r6_0 = matrix_to_rotation_6d(init_R).float()
        r6, state = r6_0, adam_init(r6_0)
        with frozen(task.unet):
            for _ in range(steps):
                with torch.enable_grad():
                    leaf = r6.detach().requires_grad_(True)
                    # the batch sum: each pose moves only its own sample's prediction
                    (grad,) = torch.autograd.grad(distances(leaf).sum(), leaf)
                update, state = adam_update(grad, state, lr)
                r6 = r6 + update
            with torch.no_grad():
                final_d, init_d = distances(r6), distances(r6_0)
        keep = final_d <= init_d
        r6 = torch.where(keep[:, None], r6, r6_0)
        return rotation_6d_to_matrix(r6), torch.where(keep, final_d, init_d)

    return refine


def make_multistart_refiner(task, steps: int = 24, lr: float = 2e-2, objective: str = "l2"):
    """Build ``refine_multi(query_latent, reference_latent, init_Rs)``:
    refine from K inits per query in one K×-wider batch and keep, per
    query, the start with the lowest final objective (the first on a tie).

    ``init_Rs``: (B, K, 3, 3), typically the retrieved top-K grid poses.
    Returns ``(refined_R, distance, selected)``: (B, 3, 3), (B,) and the
    (B,) index of the winning start."""
    refiner = make_pose_refiner(task, steps=steps, lr=lr, objective=objective)

    def refine_multi(query_latent: torch.Tensor, reference_latent: torch.Tensor,
                     init_Rs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b, k = init_Rs.shape[:2]
        # [q0, q0, .., q1, q1, ..]: start (b, k) of the (B·K) batch refines query b
        refined, d = refiner(query_latent.repeat_interleave(k, 0), reference_latent.repeat_interleave(k, 0),
                             init_Rs.reshape(b * k, 3, 3))
        d = d.reshape(b, k)
        sel = torch.argmin(d, dim=1)
        rows = torch.arange(b, device=d.device)
        return refined.reshape(b, k, 3, 3)[rows, sel], d[rows, sel], sel

    return refine_multi


def refine_pose(task, query: torch.Tensor, reference: torch.Tensor, init_R: torch.Tensor,
                steps: int = 24, lr: float = 2e-2, objective: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode both images, then refine: ``(refined_R, distance)``.  For
    repeated use build the refiner once with :func:`make_pose_refiner`."""
    refiner = make_pose_refiner(task, steps=steps, lr=lr, objective=objective)
    return refiner(task.encode(query, "mode"), task.encode(reference, "mode"), init_R)
