"""JAX parameter trees → the port's state dicts.

The exact inverses of ``nope_tpu.training.port``'s ``port_pose_unet``,
``port_sd_vae``, ``port_ldm_unet`` and ``port_adm_unet`` (one function),
``port_ldm_encoder_unet``, ``port_template_encoder`` and
``port_base_feature_extractor``: conv kernels HWIO → OIHW (a transposed
conv's too: the port tool's permutation is the same), 1x1 conv1d
kernels → (O, I, 1), Dense kernels (I, O) → Linear weights (O, I), norm
scale/bias → weight/bias, frozen BatchNorm (scale, bias, mean, var) →
(weight, bias, running_mean, running_var).  They take the
Flax ``params`` tree as nested dicts of arrays (numpy or anything
``np.asarray`` reads) and return ``{name: torch.Tensor}`` state dicts
that the port's modules load with ``strict=True``.  The reference's
dead ``final_conv.0.mlp`` has no counterpart on either side.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _conv(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _linear(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _norm(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _resnet_block(sd: StateDict, key: str, p: Mapping) -> None:
    for blk in ("block1", "block2"):
        _conv(sd, f"{key}.{blk}.proj", p[blk]["proj"])
        _norm(sd, f"{key}.{blk}.norm", p[blk]["norm"])
    if "mlp_dense" in p:
        _linear(sd, f"{key}.mlp.1", p["mlp_dense"])
    if "res_conv" in p:
        _conv(sd, f"{key}.res_conv", p["res_conv"])


def _attn_block(sd: StateDict, key: str, p: Mapping) -> None:
    _norm(sd, f"{key}.fn.norm", p["norm"])
    attn = p["attn"]
    _conv(sd, f"{key}.fn.fn.to_qkv", attn["to_qkv"])
    if "to_out_conv" in attn:  # linear attention
        _conv(sd, f"{key}.fn.fn.to_out.0", attn["to_out_conv"])
        _norm(sd, f"{key}.fn.fn.to_out.1", attn["to_out_norm"])
    else:
        _conv(sd, f"{key}.fn.fn.to_out", attn["to_out"])


def _sampler(sd: StateDict, key: str, p: Mapping, hard: bool) -> None:
    """Last stage: a bare conv3x3 at ``{key}``; otherwise the Hard
    down/upsampler's conv at index 1 of its Sequential, or the strided
    (transposed) conv itself at ``{key}``."""
    if "kernel" in p:
        _conv(sd, key, p)
    else:
        _conv(sd, f"{key}.1" if hard else key, p["conv"])


def unet_state_dict_from_jax(params: Mapping, use_hard_up_down: bool = True) -> StateDict:
    """``PoseUNet`` Flax params → the port's ``PoseUNet`` state dict."""
    sd: StateDict = {}
    mlp = params.get("pose_mlp", {})
    if "fc0" in mlp:
        _linear(sd, "pose_mlp.0", mlp["fc0"])
    if "fc1" in mlp:
        _linear(sd, "pose_mlp.2", mlp["fc1"])
    _conv(sd, "init_conv", params["init_conv"])
    stages = sorted(int(m.group(1)) for k in params if (m := re.fullmatch(r"downs_(\d+)_block1", k)))
    for i in stages:
        for side, sampler in (("downs", "down"), ("ups", "up")):
            _resnet_block(sd, f"{side}.{i}.0", params[f"{side}_{i}_block1"])
            _resnet_block(sd, f"{side}.{i}.1", params[f"{side}_{i}_block2"])
            _attn_block(sd, f"{side}.{i}.2", params[f"{side}_{i}_attn"])
            _sampler(sd, f"{side}.{i}.3", params[f"{side}_{i}_{sampler}"], use_hard_up_down)
    _resnet_block(sd, "mid_block1", params["mid_block1"])
    _attn_block(sd, "mid_attn", params["mid_attn"])
    _resnet_block(sd, "mid_block2", params["mid_block2"])
    _resnet_block(sd, "final_res_block", params["final_res_block"])
    _resnet_block(sd, "final_conv.0", params["final_conv_block"])
    _conv(sd, "final_conv.1", params["final_conv_out"])
    return sd


def _vae_resnet(sd: StateDict, key: str, p: Mapping) -> None:
    for name in ("norm1", "norm2"):
        _norm(sd, f"{key}.{name}", p[name])
    for name in ("conv1", "conv2", "conv_shortcut"):
        if name in p:
            _conv(sd, f"{key}.{name}", p[name])


def _vae_attn(sd: StateDict, key: str, p: Mapping) -> None:
    _norm(sd, f"{key}.group_norm", p["group_norm"])
    for ours, theirs in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0")):
        _linear(sd, f"{key}.{theirs}", p[ours])


def _vae_coder(sd: StateDict, prefix: str, p: Mapping, short: str, sampler: str) -> None:
    """``short`` is "down" (encoder) or "up" (decoder)."""
    _conv(sd, f"{prefix}.conv_in", p["conv_in"])
    _vae_resnet(sd, f"{prefix}.mid_block.resnets.0", p["mid_res_0"])
    _vae_attn(sd, f"{prefix}.mid_block.attentions.0", p["mid_attn"])
    _vae_resnet(sd, f"{prefix}.mid_block.resnets.1", p["mid_res_1"])
    _norm(sd, f"{prefix}.conv_norm_out", p["conv_norm_out"])
    _conv(sd, f"{prefix}.conv_out", p["conv_out"])
    for key, sub in p.items():
        if m := re.fullmatch(rf"{short}_(\d+)_res_(\d+)", key):
            _vae_resnet(sd, f"{prefix}.{short}_blocks.{m.group(1)}.resnets.{m.group(2)}", sub)
        elif m := re.fullmatch(rf"{short}_(\d+)_{sampler}", key):
            _conv(sd, f"{prefix}.{short}_blocks.{m.group(1)}.{sampler}rs.0.conv", sub["conv"])


def vae_state_dict_from_jax(params: Mapping) -> StateDict:
    """``StableDiffusionVAE`` Flax params → a diffusers-named state dict.

    Every subtree present is converted (``encoder``, ``quant_conv`` and,
    when given, ``decoder`` and ``post_quant_conv``), so the encoder-only
    subset loads into the port's encoder-side ``StableDiffusionVAE``."""
    sd: StateDict = {}
    if "encoder" in params:
        _vae_coder(sd, "encoder", params["encoder"], "down", "downsample")
    if "decoder" in params:
        _vae_coder(sd, "decoder", params["decoder"], "up", "upsample")
    for name in ("quant_conv", "post_quant_conv"):
        if name in params:
            _conv(sd, name, params[name])
    return sd


# -- LDM / ADM U-Nets and the LDM encoder (openaimodel / guided_diffusion names)


def _conv1d(sd: StateDict, key: str, p: Mapping) -> None:
    """A 1x1 conv (HWIO (1, 1, I, O)) → a Conv1d weight (O, I, 1)."""
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))[..., 0])
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _dense_conv1d(sd: StateDict, key: str, p: Mapping) -> None:
    """A Dense kernel (I, O) → a Conv1d weight (O, I, 1)."""
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T[..., None])
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _pose_mlps(sd: StateDict, params: Mapping) -> None:
    for name in ("pose_mlp", "pose_mlp_timesteps"):
        mlp = params.get(name, {})
        if "fc0" in mlp:
            _linear(sd, f"{name}.0", mlp["fc0"])
        if "fc1" in mlp:
            _linear(sd, f"{name}.2", mlp["fc1"])


def _ldm_resblock(sd: StateDict, key: str, p: Mapping) -> None:
    _norm(sd, f"{key}.in_layers.0", p["in_norm"])
    _conv(sd, f"{key}.in_layers.2", p["in_conv"])
    _linear(sd, f"{key}.emb_layers.1", p["emb_dense"])
    _norm(sd, f"{key}.out_layers.0", p["out_norm"])
    _conv(sd, f"{key}.out_layers.3", p["out_conv"])
    if "skip_conv" in p:
        _conv(sd, f"{key}.skip_connection", p["skip_conv"])


def _ldm_transformer(sd: StateDict, key: str, p: Mapping) -> None:
    _norm(sd, f"{key}.norm", p["norm"])
    _conv(sd, f"{key}.proj_in", p["proj_in"])
    _conv(sd, f"{key}.proj_out", p["proj_out"])
    depth = sum(1 for k in p if re.fullmatch(r"block_\d+", k))
    for d in range(depth):
        tb, b = f"{key}.transformer_blocks.{d}", p[f"block_{d}"]
        for name in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{tb}.{name}", b[name])
        for name in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _linear(sd, f"{tb}.{name}.{proj}", b[name][proj])
            _linear(sd, f"{tb}.{name}.to_out.0", b[name]["to_out"])
        _linear(sd, f"{tb}.ff.net.0.proj", b["ff"]["geglu"])
        _linear(sd, f"{tb}.ff.net.2", b["ff"]["proj"])


def _adm_attention(sd: StateDict, key: str, p: Mapping) -> None:
    _norm(sd, f"{key}.norm", p["norm"])
    _conv1d(sd, f"{key}.qkv", p["qkv"])
    _conv1d(sd, f"{key}.proj_out", p["proj_out"])


def _attention(sd: StateDict, key: str, p: Mapping) -> None:
    """An LDM spatial transformer or an ADM attention block, by its params."""
    (_ldm_transformer if "proj_in" in p else _adm_attention)(sd, key, p)


def _resample(sd: StateDict, key: str, p: Mapping, down: bool) -> None:
    """A resblock resampler at ``{key}``, or the conv sampler's conv
    (``{key}.op`` down, ``{key}.conv`` up)."""
    if "in_norm" in p:
        _ldm_resblock(sd, key, p)
    else:
        _conv(sd, f"{key}.{'op' if down else 'conv'}", p)


def _half_unet(sd: StateDict, params: Mapping) -> Tuple[int, int]:
    """The input side and the middle block: conv_in, every level's
    resblocks (+ attention) and samplers in the torch ModuleList's order.
    Returns (levels, res blocks a level)."""
    levels = sum(1 for k in params if re.fullmatch(r"down_\d+_res_0", k))
    per_level = sum(1 for k in params if re.fullmatch(r"down_0_res_\d+", k))
    _conv(sd, "input_blocks.0.0", params["conv_in"])
    idx = 1
    for level in range(levels):
        for i in range(per_level):
            _ldm_resblock(sd, f"input_blocks.{idx}.0", params[f"down_{level}_res_{i}"])
            if f"down_{level}_attn_{i}" in params:
                _attention(sd, f"input_blocks.{idx}.1", params[f"down_{level}_attn_{i}"])
            idx += 1
        if f"down_{level}_downsample" in params:
            _resample(sd, f"input_blocks.{idx}.0", params[f"down_{level}_downsample"], down=True)
            idx += 1
    _ldm_resblock(sd, "middle_block.0", params["mid_res_0"])
    _attention(sd, "middle_block.1", params["mid_attn"])
    _ldm_resblock(sd, "middle_block.2", params["mid_res_1"])
    return levels, per_level


def openai_unet_state_dict_from_jax(params: Mapping) -> StateDict:
    """``LDMPoseUNet`` or ``ADMPoseUNet`` Flax params → the port's state
    dict (the inverse of ``port_ldm_unet`` and of ``port_adm_unet``: the
    two share the reference's ``input_blocks`` / ``output_blocks`` layout,
    and each block's kind is read off its params)."""
    sd: StateDict = {}
    _pose_mlps(sd, params)
    levels, per_level = _half_unet(sd, params)
    jdx = 0
    for level in reversed(range(levels)):
        for i in range(per_level + 1):
            _ldm_resblock(sd, f"output_blocks.{jdx}.0", params[f"up_{level}_res_{i}"])
            sub = 1
            if f"up_{level}_attn_{i}" in params:
                _attention(sd, f"output_blocks.{jdx}.{sub}", params[f"up_{level}_attn_{i}"])
                sub += 1
            if i == per_level and f"up_{level}_upsample" in params:
                _resample(sd, f"output_blocks.{jdx}.{sub}", params[f"up_{level}_upsample"], down=False)
            jdx += 1
    _norm(sd, "out.0", params["out_norm"])
    _conv(sd, "out.2", params["out_conv"])
    return sd


def ldm_encoder_unet_state_dict_from_jax(params: Mapping) -> StateDict:
    """``LDMEncoderUNet`` Flax params → the port's state dict; the head
    (``pool``) is read off the params."""
    sd: StateDict = {}
    _linear(sd, "time_embed.0", params["time_dense_0"])
    _linear(sd, "time_embed.2", params["time_dense_1"])
    _half_unet(sd, params)
    if "out_pool" in params:  # attention
        _norm(sd, "out.0", params["out_norm"])
        pool = params["out_pool"]
        sd["out.2.positional_embedding"] = _t(np.asarray(pool["positional_embedding"]).T)
        _dense_conv1d(sd, "out.2.qkv_proj", pool["qkv_proj"])
        _dense_conv1d(sd, "out.2.c_proj", pool["c_proj"])
    elif "out_conv" in params:  # adaptive
        _norm(sd, "out.0", params["out_norm"])
        _conv(sd, "out.3", params["out_conv"])
    elif "out_norm" in params:  # spatial_v2
        _linear(sd, "out.0", params["out_dense_0"])
        _norm(sd, "out.1", params["out_norm"])
        _linear(sd, "out.3", params["out_dense_1"])
    else:  # spatial
        _linear(sd, "out.0", params["out_dense_0"])
        _linear(sd, "out.2", params["out_dense_1"])
    return sd


# -- the template encoders ------------------------------------------------------


def _frozen_bn(sd: StateDict, key: str, p: Mapping) -> None:
    for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var")):
        sd[f"{key}.{theirs}"] = _t(p[ours])


def template_encoder_state_dict_from_jax(params: Mapping) -> StateDict:
    """``TemplateFeatureExtractor`` Flax params → the port's state dict
    (``backbone.*`` with torchvision's names, ``projector.{1,3}``)."""
    sd: StateDict = {}
    backbone = params["backbone"]
    _conv(sd, "backbone.conv1", backbone["conv1"])
    _frozen_bn(sd, "backbone.bn1", backbone["bn1"])
    for name, block in backbone.items():
        if m := re.fullmatch(r"layer(\d+)_(\d+)", name):
            key = f"backbone.layer{m.group(1)}.{m.group(2)}"
            for i in (1, 2, 3):
                if f"conv{i}" in block:
                    _conv(sd, f"{key}.conv{i}", block[f"conv{i}"])
                    _frozen_bn(sd, f"{key}.bn{i}", block[f"bn{i}"])
            if "downsample_conv" in block:
                _conv(sd, f"{key}.downsample.0", block["downsample_conv"])
                _frozen_bn(sd, f"{key}.downsample.1", block["downsample_bn"])
    _conv(sd, "projector.1", params["proj1"])
    _conv(sd, "projector.3", params["proj2"])
    return sd


def base_feature_extractor_state_dict_from_jax(params: Mapping) -> StateDict:
    """``BaseFeatureExtractor`` Flax params → the port's state dict."""
    sd: StateDict = {}
    for ours, theirs in (("layer1", "encoder.0"), ("layer2", "encoder.2"), ("proj1", "encoder.4.0"),
                         ("proj2", "encoder.4.2")):
        _conv(sd, theirs, params[ours])
    return sd
