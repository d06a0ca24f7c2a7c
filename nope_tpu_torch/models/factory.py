"""Model factory (``nope_tpu/models/factory.py``): config → task.

``build_task`` reads any object with ``ModelConfig``'s fields
(``u_net``, ``encoder``, ``optim_config``, ``testing_config``), so it
needs no import of ``nope_tpu.configs``.  Only ``u_net.variant ==
"vae_base"`` with ``encoder.kind == "vae"`` is ported.

Weights are random, drawn from an explicit ``torch.Generator`` on the
CPU (so one seed gives the same weights on every device), then moved to
the explicit ``device``: LeCun-normal conv and linear weights (Flax's
default), zero biases, unit norm scales.  The draws run in the order
VAE encoder side, U-Net, VAE decoder side.  Load a checkpoint over them
with ``load_state_dict``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nope_tpu_torch.models.unet import PoseUNet
from nope_tpu_torch.models.vae import StableDiffusionVAE
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in module order; the module's tensors lie on the CPU."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


def _empty(ctor) -> nn.Module:
    with torch.device("meta"):  # no throwaway default init
        module = ctor()
    return module.to_empty(device="cpu")


def _build(ctor, generator: torch.Generator, device: torch.device) -> nn.Module:
    return init_weights(_empty(ctor), generator).to(device).eval()


def _vae(cfg) -> StableDiffusionVAE:
    if cfg.kind != "vae":
        raise NotImplementedError(f"encoder kind {cfg.kind!r} (ROADMAP queue 1 item 13)")
    return _empty(lambda: StableDiffusionVAE(
        block_out_channels=tuple(cfg.block_out_channels),
        layers_per_block=cfg.layers_per_block,
        latent_channels=cfg.latent_dim,
        groups=cfg.norm_groups,
    ))


def build_unet(cfg, latent_dim: int, generator: torch.Generator, device: torch.device) -> PoseUNet:
    if cfg.variant != "vae_base":
        raise NotImplementedError(f"u_net variant {cfg.variant!r} (ROADMAP queue 1 item 13)")
    return _build(lambda: PoseUNet(
        u_net_dim=cfg.u_net_dim,
        channels=latent_dim,
        rot_representation_dim=cfg.rot_representation_dim,
        pose_mlp_name=cfg.pose_mlp_name,
        dim_mults=tuple(cfg.dim_mults),
        resnet_block_groups=cfg.resnet_block_groups,
        double_bottleneck=cfg.double_bottleneck,
    ), generator, device)


def build_task(cfg, device: torch.device, generator: torch.Generator) -> PoseConditionalTask:
    """The task with seeded random weights on ``device`` (float32).  The
    U-Net draws between the VAE's encoder and decoder sides, so a seed
    gives the encoder and U-Net the weights they had before the decoder
    was ported."""
    vae = _vae(cfg.encoder)
    init_weights(vae.encoder, generator)
    init_weights(vae.quant_conv, generator)
    unet = build_unet(cfg.u_net, cfg.encoder.latent_dim, generator, device)
    init_weights(vae.decoder, generator)
    init_weights(vae.post_quant_conv, generator)
    task_cfg = TaskConfig(
        loss_type=cfg.optim_config.loss_type,
        use_inv_deltaR=cfg.optim_config.use_inv_deltaR,
        similarity_metric=cfg.testing_config.similarity_metric,
        retrieval_k=cfg.testing_config.retrieval_k,
        using_KL=cfg.encoder.using_KL,
        half_precision_eval=cfg.testing_config.half_precision_eval,
    )
    return PoseConditionalTask(unet, vae.to(device).eval(), task_cfg)
