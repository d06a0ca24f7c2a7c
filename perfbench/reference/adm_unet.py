"""The ADM (guided-diffusion) pose-conditioned U-Net in plain PyTorch,
float32: NOPE's ``vae_guidedDiffusion`` backend, guided-diffusion's
``UNetModel`` (Dhariwal & Nichol, arXiv 2105.05233) under the
reference's ``UNetModelPose``, with its state-dict names, so one seeded
state dict loads into it and into the program's ``models/adm_unet.py``.

The pose MLP's output is the time embedding; every res block takes it by
FiLM (``use_scale_shift_norm``) and the resampling ones are residual
up/down blocks (``resblock_updown``): this module's own
``ldm_unet.LDMResBlock``, ``EmbedSequential`` and ``skip_channels``, and
``unet.PoseMLP``.  Only the attention block and the assembly are new.

Departures from guided-diffusion, each the NOPE reference's or the
benchmark's:

- the attention's ``qkv`` is laid out per head as [q, k, v]
  (``QKVAttentionLegacy``, guided-diffusion's default order), and the
  scores are scaled by dh^-¼ on q and on k;
- ``attention_resolutions`` are downsample rates, compared with the
  running ``ds`` as ``UNetModel`` compares them (its training script
  turns image resolutions into rates first): over 32x32 latents (32, 16,
  8) fall at 1x1, 2x2 and 4x4;
- the layers guided-diffusion initialises to zero (each res block's last
  conv, each attention's ``proj_out``, the output conv) are ordinary
  layers: the benchmark draws every weight;
- no timestep, class label or dropout.

The attention's 1x1 projections are ``Conv1x1``: an ``nn.Linear`` that
keeps ``nn.Conv1d``'s (out, in, 1) weight, so the state dict is the
program's and the control (``lowp.py``: float8 on every ``nn.Linear``,
TF32 on every ``F.linear``) reaches them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .ldm_unet import EmbedSequential, LDMDownsample, LDMResBlock, LDMUpsample, skip_channels
from .unet import PoseMLP


class Conv1x1(nn.Linear):
    """A 1x1 ``nn.Conv1d`` over (B, C, T) computed as ``F.linear`` over
    the channels, its weight kept in the conv's (out, in, 1) shape."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels)
        self.weight = nn.Parameter(self.weight.detach()[..., None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.transpose(1, 2), self.weight[..., 0], self.bias).transpose(1, 2)


class ADMAttentionBlock(nn.Module):
    """GN32 → qkv (legacy per-head [q, k, v] layout) → softmax(q·kᵀ /
    √dh) · v per head → proj_out, plus the input."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.GroupNorm(32, channels, eps=1e-5)
        self.qkv = Conv1x1(channels, channels * 3)
        self.proj_out = Conv1x1(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t, dh = h * w, c // self.num_heads
        qkv = self.qkv(self.norm(x).reshape(b, c, t))
        q, k, v = qkv.reshape(b * self.num_heads, 3 * dh, t).split(dh, dim=1)
        scale = dh ** -0.25
        weight = torch.softmax(torch.matmul((q * scale).transpose(1, 2), k * scale), dim=-1)  # (bh, t, s)
        out = torch.matmul(v, weight.transpose(1, 2)).reshape(b, c, t)
        return x + self.proj_out(out).reshape(b, c, h, w)


class ADMPoseUNet(nn.Module):
    """UNetModelPose over guided-diffusion's UNetModel; the constructor's
    defaults are the published 256x256 model's flags."""

    def __init__(
        self,
        in_channels: int = 4,
        out_channels: int = 4,
        model_channels: int = 256,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (32, 16, 8),
        channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
        num_head_channels: int = 64,
        num_heads: int = 4,
        use_scale_shift_norm: bool = True,
        resblock_updown: bool = True,
        rot_representation_dim: int = 6,
        pose_mlp_name: str = "single_layer",
    ):
        super().__init__()
        emb = model_channels * 4
        self.pose_mlp = PoseMLP(rot_representation_dim, emb, pose_mlp_name)

        def heads(ch):
            return max(1, ch // num_head_channels) if num_head_channels > 0 else num_heads

        def res(ch, out_ch, **kw):
            return LDMResBlock(ch, emb, out_ch, use_scale_shift_norm=use_scale_shift_norm, **kw)

        self.input_blocks = nn.ModuleList([EmbedSequential(nn.Conv2d(in_channels, model_channels, 3, padding=1))])
        ch, ds = model_channels, 1
        for level, mult in enumerate(channel_mult):
            out_ch = model_channels * mult
            for _ in range(num_res_blocks):
                mods = [res(ch, out_ch)]
                ch = out_ch
                if ds in attention_resolutions:
                    mods.append(ADMAttentionBlock(ch, heads(ch)))
                self.input_blocks.append(EmbedSequential(*mods))
            if level != len(channel_mult) - 1:
                self.input_blocks.append(EmbedSequential(res(ch, ch, down=True) if resblock_updown
                                                         else LDMDownsample(ch)))
                ds *= 2

        self.middle_block = EmbedSequential(res(ch, ch), ADMAttentionBlock(ch, heads(ch)), res(ch, ch))

        skips = skip_channels(model_channels, channel_mult, num_res_blocks)
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            out_ch = model_channels * mult
            for i in range(num_res_blocks + 1):
                mods = [res(ch + skips.pop(), out_ch)]
                ch = out_ch
                if ds in attention_resolutions:
                    mods.append(ADMAttentionBlock(ch, heads(ch)))
                if level and i == num_res_blocks:
                    mods.append(res(ch, ch, up=True) if resblock_updown else LDMUpsample(ch))
                    ds //= 2
                self.output_blocks.append(EmbedSequential(*mods))

        self.out = nn.Sequential(nn.GroupNorm(32, ch, eps=1e-5), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))

    def forward(self, x: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) latents; pose: (B, rot_representation_dim)."""
        emb = self.pose_mlp(pose)
        h = x
        hs = []
        for module in self.input_blocks:
            h = module(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for module in self.output_blocks:
            h = module(torch.cat([h, hs.pop()], dim=1), emb)
        return self.out(h)
