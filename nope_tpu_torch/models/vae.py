"""Stable-Diffusion VAE encoder (``nope_tpu/models/vae.py``), NCHW inside.

diffusers ``AutoencoderKL`` state-dict names (``encoder.*``,
``quant_conv``), so the JAX package's ``port_sd_vae`` maps them.  Only
the encoder side is ported; the decoder is later work.  These are plain
PyTorch ops, as they were XLA ops in JAX.  :meth:`encode_image` keeps
the JAX package's NHWC boundary.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nope_tpu_torch.models.distributions import DiagonalGaussian

SD_LATENT_SCALE = 0.18215


class VAEResnetBlock(nn.Module):
    """GN → SiLU → conv3x3 → GN → SiLU → conv3x3 (+1x1 shortcut)."""

    def __init__(self, dim: int, dim_out: int, groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, dim, eps=1e-6)
        self.conv1 = nn.Conv2d(dim, dim_out, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, dim_out, eps=1e-6)
        self.conv2 = nn.Conv2d(dim_out, dim_out, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention with 1/sqrt(C) scaling."""

    def __init__(self, dim: int, groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.group_norm(x).reshape(b, c, hh * ww).transpose(1, 2)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * c**-0.5, dim=-1)
        out = self.to_out[0](torch.bmm(attn, v))
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


class VAEDownsample(nn.Module):
    """conv3x3 stride 2 after diffusers' asymmetric (0, 1, 0, 1) padding."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _DownBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, layers: int, groups: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(dim if j == 0 else dim_out, dim_out, groups) for j in range(layers)]
        )
        self.downsamplers = nn.ModuleList([VAEDownsample(dim_out)]) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class _MidBlock(nn.Module):
    def __init__(self, dim: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(dim, dim, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttnBlock(dim, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEEncoder(nn.Module):
    def __init__(
        self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
        layers_per_block: int = 2, latent_channels: int = 4, groups: int = 32,
    ):
        super().__init__()
        chans = tuple(block_out_channels)
        self.conv_in = nn.Conv2d(3, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [
                _DownBlock(chans[max(i - 1, 0)], ch, layers_per_block, groups, i < len(chans) - 1)
                for i, ch in enumerate(chans)
            ]
        )
        self.mid_block = _MidBlock(chans[-1], groups)
        self.conv_norm_out = nn.GroupNorm(groups, chans[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class StableDiffusionVAE(nn.Module):
    """The encoder half of AutoencoderKL with ``quant_conv`` and the SD
    latent scale."""

    def __init__(
        self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
        layers_per_block: int = 2, latent_channels: int = 4, groups: int = 32,
    ):
        super().__init__()
        self.encoder = VAEEncoder(block_out_channels, layers_per_block, latent_channels, groups)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)

    def encode(self, image: torch.Tensor) -> DiagonalGaussian:
        """(B, H, W, 3) NHWC images → distribution over (B, h, w, C) latents."""
        x = image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        moments = self.quant_conv(self.encoder(x))
        return DiagonalGaussian.from_parameters(moments.permute(0, 2, 3, 1))

    def encode_image(self, image: torch.Tensor, mode: str = "mode") -> torch.Tensor:
        """Scaled latent mean, (B, h, w, C)."""
        if mode != "mode":
            raise NotImplementedError(f"encode_image mode {mode!r} (ROADMAP queue 1 item 4)")
        return (self.encode(image).mode() * SD_LATENT_SCALE).contiguous()
