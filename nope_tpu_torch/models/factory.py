"""Model factory (``nope_tpu/models/factory.py``): config → task.

``build_task`` reads any object with ``ModelConfig``'s fields
(``u_net``, ``encoder``, ``optim_config``, ``testing_config``), so it
needs no import of ``nope_tpu.configs``.  Every U-Net variant the JAX
factory builds (``vae_base`` and ``template_base``: ``PoseUNet``;
``vae_cin_ldm``: ``LDMPoseUNet``; ``vae_guidedDiffusion``:
``ADMPoseUNet``) and every encoder kind (``vae``: the SD-VAE;
``template``: the ResNet-50 ``TemplateFeatureExtractor``;
``template_tiny``: ``BaseFeatureExtractor``), from the same config
fields.  The U-Net's input width is ``encoder.latent_dim``.  The ADM
takes the LDM's ``num_head_channels``, whose default is the LDM's 32: a
``UNetConfig`` left at its defaults builds the ADM with twice its
published heads, and ``configs/model_adm.yaml`` builds the published
model (heads of 64 channels).

Weights are random, drawn from an explicit ``torch.Generator`` on the
CPU (so one seed gives the same weights on every device), then moved to
the explicit ``device``: LeCun-normal conv and linear weights (Flax's
default), zero biases, unit norm scales, BatchNorm statistics (0, 1);
the layers JAX initialises to zero (``blocks.zero_module``) stay zero.
The draws run in the order encoder, U-Net, then the VAE's decoder side.
Load a checkpoint over them with ``load_state_dict``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nope_tpu_torch.models.blocks import ChannelLayerNorm, ImagenCrossAttention
from nope_tpu_torch.models.ldm_encoder import AttentionPool2d
from nope_tpu_torch.models.resnet import FrozenBatchNorm
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig

_DRAWN = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in module order; the module's tensors lie on the CPU."""
    for m in module.modules():
        if isinstance(m, _DRAWN):
            if getattr(m, "zero_init", False):
                m.weight.zero_()
            else:
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm, FrozenBatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, FrozenBatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, ChannelLayerNorm):
            m.g.fill_(1.0)
        elif isinstance(m, ImagenCrossAttention):
            m.null_kv.normal_(0.0, 1.0, generator=generator)
            m.q_scale.fill_(1.0)
            m.k_scale.fill_(1.0)
        elif isinstance(m, AttentionPool2d):
            pos = m.positional_embedding
            pos.normal_(0.0, pos.shape[0] ** -0.5, generator=generator)
    return module


def _empty(ctor) -> nn.Module:
    with torch.device("meta"):  # no throwaway default init
        module = ctor()
    return module.to_empty(device="cpu")


def _build(ctor, generator: torch.Generator, device: torch.device) -> nn.Module:
    return init_weights(_empty(ctor), generator).to(device).eval()


def _encoder(cfg) -> nn.Module:
    if cfg.kind == "vae":
        from nope_tpu_torch.models.vae import StableDiffusionVAE

        return _empty(lambda: StableDiffusionVAE(
            block_out_channels=tuple(cfg.block_out_channels),
            layers_per_block=cfg.layers_per_block,
            latent_channels=cfg.latent_dim,
            groups=cfg.norm_groups,
        ))
    if cfg.kind == "template":
        from nope_tpu_torch.models.template_encoder import TemplateFeatureExtractor

        return _empty(lambda: TemplateFeatureExtractor(descriptor_size=cfg.descriptor_size, normalize=cfg.normalize))
    if cfg.kind == "template_tiny":
        from nope_tpu_torch.models.template_encoder import BaseFeatureExtractor

        return _empty(lambda: BaseFeatureExtractor(descriptor_size=cfg.descriptor_size))
    raise ValueError(f"unknown encoder kind {cfg.kind!r}")


def _unet(cfg, latent_dim: int) -> nn.Module:
    if cfg.variant in ("vae_base", "template_base"):
        from nope_tpu_torch.models.unet import PoseUNet

        return PoseUNet(
            u_net_dim=cfg.u_net_dim,
            channels=latent_dim,
            rot_representation_dim=cfg.rot_representation_dim,
            pose_mlp_name=cfg.pose_mlp_name,
            dim_mults=tuple(cfg.dim_mults),
            resnet_block_groups=cfg.resnet_block_groups,
            double_bottleneck=cfg.double_bottleneck,
        )
    if cfg.variant == "vae_cin_ldm":
        from nope_tpu_torch.models.ldm_unet import LDMPoseUNet

        return LDMPoseUNet(
            in_channels=latent_dim,
            out_channels=latent_dim,
            model_channels=cfg.model_channels,
            num_res_blocks=cfg.num_res_blocks,
            attention_resolutions=tuple(cfg.attention_resolutions),
            channel_mult=tuple(cfg.channel_mult),
            num_head_channels=cfg.num_head_channels,
            context_dim=cfg.context_dim,
            transformer_depth=cfg.transformer_depth,
            rot_representation_dim=cfg.rot_representation_dim,
            pose_mlp_name=cfg.pose_mlp_name,
            injecting_condition_twice=cfg.injecting_condition_twice,
        )
    if cfg.variant == "vae_guidedDiffusion":
        from nope_tpu_torch.models.adm_unet import ADMPoseUNet

        return ADMPoseUNet(
            in_channels=latent_dim,
            out_channels=latent_dim,
            model_channels=cfg.model_channels,
            num_res_blocks=cfg.num_res_blocks,
            attention_resolutions=tuple(cfg.gd_attention_resolutions),
            channel_mult=tuple(cfg.gd_channel_mult),
            num_head_channels=cfg.num_head_channels,
            num_heads=cfg.num_heads,
            use_scale_shift_norm=cfg.use_scale_shift_norm,
            resblock_updown=cfg.resblock_updown,
            rot_representation_dim=cfg.rot_representation_dim,
            pose_mlp_name=cfg.pose_mlp_name,
        )
    raise ValueError(f"unknown u_net variant {cfg.variant!r}")


def build_unet(cfg, latent_dim: int, generator: torch.Generator, device: torch.device) -> nn.Module:
    """The U-Net of ``cfg.variant`` (``cfg``: a ``UNetConfig``), seeded,
    float32 on ``device``."""
    return _build(lambda: _unet(cfg, latent_dim), generator, device)


def build_encoder(cfg, generator: torch.Generator, device: torch.device) -> nn.Module:
    """The encoder of ``cfg.kind`` alone (``cfg``: an ``EncoderConfig``),
    seeded in module order, float32 on ``device``."""
    return init_weights(_encoder(cfg), generator).to(device).eval()


def build_vae(cfg, generator: torch.Generator, device: torch.device) -> nn.Module:
    """The VAE alone, seeded in module order, float32 on ``device``: what
    VAE pretraining starts from."""
    if cfg.kind != "vae":
        raise ValueError(f"encoder kind {cfg.kind!r} is not a VAE")
    return build_encoder(cfg, generator, device)


def build_task(cfg, device: torch.device, generator: torch.Generator) -> PoseConditionalTask:
    """The task with seeded random weights on ``device`` (float32).  A
    VAE's U-Net draws between its encoder and decoder sides, so a seed
    gives the encoder and U-Net the weights they had before the decoder
    was ported."""
    encoder = _encoder(cfg.encoder)
    if cfg.encoder.kind == "vae":
        init_weights(encoder.encoder, generator)
        init_weights(encoder.quant_conv, generator)
        unet = build_unet(cfg.u_net, cfg.encoder.latent_dim, generator, device)
        init_weights(encoder.decoder, generator)
        init_weights(encoder.post_quant_conv, generator)
    else:
        init_weights(encoder, generator)
        unet = build_unet(cfg.u_net, cfg.encoder.latent_dim, generator, device)
    task_cfg = TaskConfig(
        loss_type=cfg.optim_config.loss_type,
        use_inv_deltaR=cfg.optim_config.use_inv_deltaR,
        similarity_metric=cfg.testing_config.similarity_metric,
        retrieval_k=cfg.testing_config.retrieval_k,
        using_KL=cfg.encoder.using_KL,
        half_precision_eval=cfg.testing_config.half_precision_eval,
    )
    return PoseConditionalTask(unet, encoder.to(device).eval(), task_cfg)
