"""ADM-style pose-conditioned U-Net (``nope_tpu/models/adm_unet.py``).

NCHW modules with the reference's state-dict names (guided-diffusion's
``UNetModel`` under ``UNetModelPose``), which
``nope_tpu.training.port.port_adm_unet`` maps: the pose MLP's output is
the time embedding, FiLM conditioning (``use_scale_shift_norm``),
residual up/down blocks (``resblock_updown``) and QKV self-attention at
the deeper scales.  Plain PyTorch throughout, as in JAX (no Pallas
kernel); the attention's scores are written out as JAX writes them.

Defaults mirror the reference's ``vae_guidedDiffusion.yaml``:
model_channels 256, channel_mult (1, 1, 2, 2, 4, 4), attention at ds
(32, 16, 8), num_head_channels 64.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from nope_tpu_torch.models.blocks import PoseMLP, zero_module
from nope_tpu_torch.models.ldm_unet import EmbedSequential, LDMDownsample, LDMResBlock, LDMUpsample, skip_channels


def legacy_qkv_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, 3C, T) with the legacy per-head [q, k, v] channel layout →
    (B, C, T): q and k each scaled by dh^-¼, softmax over keys."""
    b, width, t = qkv.shape
    dh = width // (3 * heads)
    q, k, v = qkv.reshape(b * heads, 3 * dh, t).split(dh, dim=1)
    scale = 1.0 / (dh ** 0.25)
    weight = torch.softmax(torch.matmul((q * scale).transpose(1, 2), k * scale), dim=-1)  # (bh, t, s)
    return torch.matmul(v, weight.transpose(1, 2)).reshape(b, -1, t)


def qkv_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, 3C, T) with the [all q | all k | all v] layout, heads-major in
    each → (B, C, T): the new-order ``QKVAttention``."""
    b, width, t = qkv.shape
    dh = width // (3 * heads)
    q, k, v = (x.reshape(b * heads, dh, t) for x in qkv.chunk(3, dim=1))
    scale = 1.0 / (dh ** 0.25)
    weight = torch.softmax(torch.matmul((q * scale).transpose(1, 2), k * scale), dim=-1)
    return torch.matmul(v, weight.transpose(1, 2)).reshape(b, -1, t)


class ADMAttentionBlock(nn.Module):
    """GN32 → qkv 1x1 conv1d (legacy per-head [q, k, v] layout) → scaled
    dot-product attention → zero 1x1 conv1d, plus the input."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.GroupNorm(32, channels, eps=1e-5)
        self.qkv = nn.Conv1d(channels, channels * 3, 1)
        self.proj_out = zero_module(nn.Conv1d(channels, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        qkv = self.qkv(self.norm(x).reshape(b, c, h * w))
        out = self.proj_out(legacy_qkv_attention(qkv, self.num_heads))
        return x + out.reshape(b, c, h, w)


class ADMPoseUNet(nn.Module):
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
        self.rot_representation_dim = rot_representation_dim
        emb = model_channels * 4
        ssn = use_scale_shift_norm
        self.pose_mlp = PoseMLP(rot_representation_dim, emb, pose_mlp_name)

        def heads(ch):
            return max(1, ch // num_head_channels) if num_head_channels > 0 else num_heads

        def res(ch, out_ch, **kw):
            return LDMResBlock(ch, emb, out_ch, use_scale_shift_norm=ssn, **kw)

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
                                 zero_module(nn.Conv2d(ch, out_channels, 3, padding=1)))

    def forward(self, x: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) latents; pose: (B, rot_representation_dim)."""
        emb = self.pose_mlp(pose)
        h = x.contiguous(memory_format=torch.channels_last)
        hs = []
        for module in self.input_blocks:
            h = module(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for module in self.output_blocks:
            h = module(torch.cat([h, hs.pop()], dim=1), emb)
        return self.out(h)
