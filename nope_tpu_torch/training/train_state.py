"""Train state and the train step (``nope_tpu/training/train_state.py``).

One step: the symmetrized loss over every dataset of the combined batch
(``PoseConditionalTask.multi_dataset_loss``), its backward into the
U-Net's float32 master weights, the optimizer update and, with
``ema_decay``, the EMA of the updated weights.  The VAE is frozen: it
runs under ``torch.no_grad`` (``PoseConditionalTask.encode``) and has no
optimizer state.

On the card the U-Net's ResnetBlocks run K3 and its linear attentions
K2 forward; their backward recomputes the plain versions
(``ops.fused_resnet._ResnetBlockFn``, ``ops.linear_attention.
_LinearAttentionFn``), with the weight gradients of every block.

Data-parallel (``make_train_step(mesh=...)``): each rank of the data
axis runs its slice of the global batch and the gradients are averaged
over the ranks explicitly after ``backward()``.  The bf16 U-Net runs
through ``torch.func.functional_call`` on bf16 copies of the masters,
which ``DistributedDataParallel``'s forward hooks would not see; the
explicit all-reduce needs no hooks and reduces the float32 masters'
``.grad`` whatever path filled them.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from nope_tpu_torch.models.adm_unet import ADMAttentionBlock
from nope_tpu_torch.models.blocks import (
    ConditionalResnetBlock,
    DualConditionalResnetBlock,
    PoseMLP,
    ResidualPreNormAttention,
    ResnetBlock,
)
from nope_tpu_torch.models.ldm_unet import LDMSpatialTransformer
from nope_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_mean_
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, cast_half
from nope_tpu_torch.training.optim import Optimizer, ema_update


@dataclasses.dataclass
class TrainState:
    """The step count, the float32 U-Net (the master weights), the frozen
    VAE and the optimizer over the U-Net's parameters.  Unlike the JAX
    package's immutable state, the train step updates it in place."""

    step: int
    unet: nn.Module
    vae: nn.Module
    opt: Optimizer


def create_train_state(task: PoseConditionalTask, opt: Optimizer) -> TrainState:
    """The task's modules (seeded or loaded by the caller) at step 0; the
    VAE's parameters stop asking for gradients."""
    task.vae.requires_grad_(False)
    return TrainState(step=0, unet=task.unet, vae=task.vae, opt=opt)


GRAD_TRACE_GROUPS = ("pose_mlp", "cond_mlp", "attn", "conv")


def _grad_trace_groups(unet: nn.Module) -> Dict[str, str]:
    """Parameter name → diagnostic group, by the module that owns it, as
    the JAX package groups its Flax paths (``_grad_trace_group``): the
    pose embedding MLPs (``pose_mlp``, also the LDM's
    ``pose_mlp_timesteps``), each ResnetBlock's conditioning MLP
    (``cond_mlp``, JAX's ``mlp_dense`` and ``mlp_ref``), the attention
    blocks (``attn``: PoseUNet's with their pre-norm, the port's
    ``downs.i.2`` / ``ups.i.2`` having no "attn" in the name; the LDM's
    spatial transformers and the ADM's attention blocks whole, JAX's
    ``*_attn_*``), and the conv trunk (``conv``, with the LDM and ADM
    ResBlocks' embedding layers, JAX's ``emb_dense``)."""
    out: Dict[str, str] = {}

    def visit(module: nn.Module, prefix: str, group: str) -> None:
        for name, p in module.named_parameters(recurse=False):
            out[prefix + name] = group
        for name, child in module.named_children():
            g = group
            if group == "conv":
                if isinstance(child, PoseMLP):
                    g = "pose_mlp"
                elif isinstance(child, (ResidualPreNormAttention, LDMSpatialTransformer, ADMAttentionBlock)):
                    g = "attn"
                elif isinstance(module, (ResnetBlock, ConditionalResnetBlock, DualConditionalResnetBlock)) \
                        and name in ("mlp", "mlp_ref"):
                    g = "cond_mlp"
            visit(child, f"{prefix}{name}.", g)

    visit(unet, "", "conv")
    return out


def _group_norms(named: Dict[str, torch.Tensor], groups: Dict[str, str], prefix: str) -> Dict[str, torch.Tensor]:
    """Per-group L2 norms (and the global one) of a gradient or update,
    on the device; a group with no parameter (the LDM's ``cond_mlp``) is a
    zero there too."""
    device = next(iter(named.values())).device
    sq: Dict[str, Any] = {g: torch.zeros((), device=device) for g in GRAD_TRACE_GROUPS}
    for name, t in named.items():
        sq[groups[name]] = sq[groups[name]] + torch.sum(torch.square(t.float()))
    out = {f"{prefix}/{g}": torch.sqrt(v) for g, v in sq.items()}
    out[f"{prefix}/global"] = torch.sqrt(sum(sq.values()))
    return out


def device_batch(x, device: torch.device) -> torch.Tensor:
    """One batch array on ``device``; the uint8 wire is normalised there,
    in float32 (``x/255·2−1``), before any cast."""
    x = torch.as_tensor(x).to(device, non_blocking=True)
    if x.dtype == torch.uint8:
        return x.float() / 255.0 * 2.0 - 1.0
    return x


class _HalfCopy:
    """The bfloat16 copy (``cast_half``) of a frozen module, made once and
    made again only when the module's weights or buffers (a ResNet's
    BatchNorm statistics) change in place (a warm start or a restore
    bumps their ``_version``) or another module comes."""

    def __init__(self):
        self._ref, self._key, self._copy = None, None, None

    def __call__(self, module: nn.Module) -> nn.Module:
        key = tuple(t._version for t in (*module.parameters(), *module.buffers()))
        if self._ref is None or self._ref() is not module or key != self._key:
            self._ref, self._key, self._copy = weakref.ref(module), key, cast_half(module)
        return self._copy


def make_train_step(
    task: PoseConditionalTask,
    half_precision: bool = False,
    state_shardings: Any = None,
    grad_trace: bool = False,
    ema_decay: float = 0.0,
    mesh: Any = None,
):
    """The train step: ``(state, {dataset: batch}) → (state, metrics)``,
    the state updated in place.  Batches hold numpy arrays or tensors
    (moved to the U-Net's device).  ``metrics`` holds device tensors:
    ``loss/train_avg`` and ``loss/train_<dataset>``, and with
    ``grad_trace`` the per-group norms of the raw gradients (``gnorm/*``)
    and of the applied updates (``unorm/*``, the parameters' change).

    ``half_precision`` runs forward and backward in bfloat16 over the
    float32 masters, as the JAX package casts at the loss boundary: the
    U-Net runs on bfloat16 copies of its parameters
    (``torch.func.functional_call``), whose cast is differentiable, so
    the gradients land in float32 ``.grad``; the frozen VAE runs on a
    bfloat16 copy made once.  No autocast: it would not reach K3 and K2,
    and K3 takes every parameter in its input's dtype.

    ``ema_decay`` > 0 makes it ``(state, batches, ema) → (state, metrics,
    ema)``: ``ema`` (a module shaped as the U-Net) becomes
    β·ema + (1−β)·params on the post-update parameters, in the same call.

    ``mesh`` (``parallel.mesh.Mesh``) makes the step data-parallel: each
    rank runs its part of the global batch, then the float32 master
    gradients are averaged over the mesh's data axis (SUM, then / D, in
    fixed buckets of the parameters in order) before the optimizer, and
    so are the metrics: every rank logs the global loss and takes the
    same update.  ``state_shardings`` (from ``parallel.zero.
    zero1_state_shardings``, whose optimizer is then ZeRO-1) brings its
    mesh."""
    if state_shardings is not None:
        mesh = state_shardings.mesh
    group = None if mesh is None else mesh.group(DATA_AXIS)
    half_vae = _HalfCopy()

    def loss_fn(state: TrainState, batches) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        device = next(state.unet.parameters()).device
        batches = {name: {k: device_batch(v, device) for k, v in b.items()} for name, b in batches.items()}
        if half_precision:
            params = {n: p.to(torch.bfloat16) for n, p in state.unet.named_parameters()}

            def unet(x, pose):
                return torch.func.functional_call(state.unet, params, (x, pose))

            vae = half_vae(state.vae)
            batches = {name: {k: cast_half(v) for k, v in b.items()} for name, b in batches.items()}
        else:
            unet, vae = state.unet, state.vae
        avg, per_dataset = PoseConditionalTask(unet, vae, task.config).multi_dataset_loss(batches)
        return avg.float(), {k: v.float() for k, v in per_dataset.items()}

    def core(state: TrainState, batches) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        state.opt.zero_grad()
        with torch.enable_grad():
            avg, per_dataset = loss_fn(state, batches)
            avg.backward()
        metrics = {"loss/train_avg": avg.detach()}
        metrics.update({f"loss/train_{k}": v.detach() for k, v in per_dataset.items()})
        if group is not None:
            params = list(state.unet.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_mean_([p.grad for p in params], group)
            values = torch.stack([v.reshape(()) for v in metrics.values()])
            all_reduce_mean_([values], group)
            metrics = dict(zip(metrics, values.unbind()))
        if grad_trace:
            named = dict(state.unet.named_parameters())
            trace = _grad_trace_groups(state.unet)
            metrics.update(_group_norms(
                {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in named.items()},
                trace, "gnorm"))
            before = {n: p.detach().clone() for n, p in named.items()}
        state.opt.step()
        if grad_trace:
            metrics.update(_group_norms({n: p.detach() - before[n] for n, p in named.items()}, trace, "unorm"))
        state.step += 1
        return state, metrics

    if ema_decay:

        def train_step_ema(state: TrainState, batches, ema: nn.Module):
            state, metrics = core(state, batches)
            ema_update(list(ema.parameters()), list(state.unet.parameters()), ema_decay)
            return state, metrics, ema

        return train_step_ema

    def train_step(state: TrainState, batches):
        return core(state, batches)

    return train_step


def to_numpy_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One host read of every metric."""
    if not metrics:
        return {}
    keys = list(metrics)
    values = torch.stack([metrics[k].float().reshape(()) for k in keys]).cpu().numpy()
    return {k: float(v) for k, v in zip(keys, np.asarray(values))}
