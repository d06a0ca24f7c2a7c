"""JAX parameter trees → the port's state dicts.

The exact inverses of ``nope_tpu.training.port.port_pose_unet`` and
``port_sd_vae``: conv kernels HWIO → OIHW, Dense kernels (I, O) →
Linear weights (O, I), norm scale/bias → weight/bias.  They take the
Flax ``params`` tree as nested dicts of arrays (numpy or anything
``np.asarray`` reads) and return ``{name: torch.Tensor}`` state dicts
that the port's modules load with ``strict=True``.  The reference's
dead ``final_conv.0.mlp`` has no counterpart on either side.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

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


def _sampler(sd: StateDict, key: str, p: Mapping) -> None:
    """Last stage: a bare conv3x3 at ``{key}``; otherwise the Hard
    down/upsampler's conv at index 1 of its Sequential."""
    if "kernel" in p:
        _conv(sd, key, p)
    else:
        _conv(sd, f"{key}.1", p["conv"])


def unet_state_dict_from_jax(params: Mapping) -> StateDict:
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
            _sampler(sd, f"{side}.{i}.3", params[f"{side}_{i}_{sampler}"])
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
