"""The SD-VAE in plain PyTorch, float32: a frozen copy of the program's
``models/vae.py`` (diffusers ``AutoencoderKL`` state-dict names, so one
seeded state dict loads into both).  The decoder is kept so that the
state dicts match; only the encoder runs here.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

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


class VAEUpsample(nn.Module):
    """Nearest-neighbour 2x, then conv3x3."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


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


class _UpBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, layers: int, groups: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(dim if j == 0 else dim_out, dim_out, groups) for j in range(layers)]
        )
        self.upsamplers = nn.ModuleList([VAEUpsample(dim_out)]) if upsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
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


class VAEDecoder(nn.Module):
    """conv_in → mid block → up blocks of ``layers_per_block + 1``
    resnets (channels reversed, 2x upsample but the last) → GN → SiLU →
    conv_out."""

    def __init__(
        self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
        layers_per_block: int = 2, out_channels: int = 3, groups: int = 32,
        latent_channels: int = 4,
    ):
        super().__init__()
        chans = tuple(reversed(tuple(block_out_channels)))
        self.conv_in = nn.Conv2d(latent_channels, chans[0], 3, padding=1)
        self.mid_block = _MidBlock(chans[0], groups)
        self.up_blocks = nn.ModuleList(
            [
                _UpBlock(chans[max(i - 1, 0)], ch, layers_per_block + 1, groups, i < len(chans) - 1)
                for i, ch in enumerate(chans)
            ]
        )
        self.conv_norm_out = nn.GroupNorm(groups, chans[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chans[-1], out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class StableDiffusionVAE(nn.Module):
    """AutoencoderKL with ``quant_conv``/``post_quant_conv`` and the SD
    latent scale.  The decoder is registered after the encoder side, so
    seeded initialisation in module order draws the encoder's weights
    first."""

    def __init__(
        self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
        layers_per_block: int = 2, latent_channels: int = 4, groups: int = 32,
        sample_channels: int = 3,
    ):
        super().__init__()
        # the latent geometry: downscale 2**(len(block_out_channels) - 1), latent_channels channels
        self.block_out_channels = tuple(block_out_channels)
        self.latent_channels = latent_channels
        self.encoder = VAEEncoder(block_out_channels, layers_per_block, latent_channels, groups)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.decoder = VAEDecoder(block_out_channels, layers_per_block, sample_channels, groups,
                                  latent_channels)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    def encode_mean(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC images → (B, h, w, C) latent mean, unscaled."""
        moments = self.quant_conv(self.encoder(image.permute(0, 3, 1, 2)))
        return moments.permute(0, 2, 3, 1)[..., : moments.shape[1] // 2]

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """The scaled latent mean (the mode), (B, h, w, C)."""
        return (self.encode_mean(image) * SD_LATENT_SCALE).contiguous()
