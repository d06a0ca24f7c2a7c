"""Stable-Diffusion VAE (``nope_tpu/models/vae.py``), NCHW inside.

diffusers ``AutoencoderKL`` state-dict names (``encoder.*``,
``quant_conv``, ``decoder.*``, ``post_quant_conv``), so the JAX
package's ``port_sd_vae`` maps them.  Plain PyTorch ops, as they were
XLA ops in JAX, but for the float32 convs on the card where no gradient
is asked (the eval step's loss, the trainer's ``train_loss``, the BOP
and ShapeNet CLIs): cuDNN runs them on the CUDA cores, so those that
:func:`~nope_tpu_torch.ops.fused_resnet.tf32x3_routes` takes -- the
resnets' stride-1 3x3 convs and 1x1 shortcuts at 128-512 channels --
run on the tensor cores through the hand-written 3xTF32 conv
(``fused_resnet.conv_tf32x3``, float32's accuracy), over the NHWC view
of the channels-last activations, and the GroupNorm + SiLU before such
a conv runs there too, on the channels-last GroupNorm kernel pair
(``fused_resnet.group_norm_film_silu_nhwc``), so the route makes no
layout copies.  ``conv_in`` (3 channels), the stride-2
downsamplers, ``conv_out`` (8) and ``quant_conv`` keep cuDNN; bf16,
the CPU and training keep every op plain.  The counters
``vae.tf32x3_convs`` and ``vae.cudnn_convs`` (``utils.profiling``)
count a float32 VAE's convs on the card by route.
:meth:`StableDiffusionVAE.encode_image` and
:meth:`StableDiffusionVAE.decode_latent` keep the JAX package's NHWC
boundary and the SD latent scale 0.18215.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nope_tpu_torch.models.blocks import nchw, nhwc
from nope_tpu_torch.models.distributions import DiagonalGaussian
from nope_tpu_torch.ops import fused_resnet as fr
from nope_tpu_torch.utils import profiling

SD_LATENT_SCALE = 0.18215


def _routes(conv: nn.Conv2d, x: torch.Tensor, norm: Optional[nn.GroupNorm] = None) -> bool:
    """Whether ``conv`` of ``x`` takes the 3xTF32 route
    (``fused_resnet.tf32x3_routes``), with ``norm`` before it where the
    channels-last GroupNorm pair takes it (``fused_resnet.nhwc_norm_fits``);
    counted by route."""
    grad = torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, conv.weight, conv.bias))
    routed = fr.tf32x3_routes(x.dtype, x.device.type, grad, conv.stride, conv.padding, conv.kernel_size,
                              conv.in_channels, conv.out_channels) and (
        norm is None or fr.nhwc_norm_fits(x.dtype, norm.num_channels, norm.num_groups))
    if routed:
        profiling.count("vae.tf32x3_convs")
    elif x.dtype == torch.float32 and x.device.type == "cuda":
        profiling.count("vae.cudnn_convs")
    return routed


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``; routed, the 3xTF32 conv of the NHWC view (its output
    an NCHW view in channels-last memory)."""
    if _routes(conv, x):
        return nchw(fr.conv_tf32x3(nhwc(x), conv.weight, conv.bias))
    return conv(x)


def _norm_silu_conv(norm: nn.GroupNorm, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(SiLU(norm(x)))``; where ``conv`` is routed, GroupNorm and
    SiLU over the NHWC view too."""
    if _routes(conv, x, norm):
        h = fr.group_norm_film_silu_nhwc(nhwc(x), norm.weight, norm.bias, norm.num_groups, norm.eps)
        return nchw(fr.conv_tf32x3(h, conv.weight, conv.bias))
    return conv(F.silu(norm(x)))


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
        h = _norm_silu_conv(self.norm1, self.conv1, x)
        h = _norm_silu_conv(self.norm2, self.conv2, h)
        if self.conv_shortcut is not None:
            x = _conv(self.conv_shortcut, x)
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
        return _conv(self.conv, F.pad(x, (0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    """Nearest-neighbour 2x, then conv3x3."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(self.conv, F.interpolate(x, scale_factor=2.0, mode="nearest"))


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
        x = _conv(self.conv_in, x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return _norm_silu_conv(self.conv_norm_out, self.conv_out, x)


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
        x = self.mid_block(_conv(self.conv_in, z))
        for block in self.up_blocks:
            x = block(x)
        return _norm_silu_conv(self.conv_norm_out, self.conv_out, x)


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

    def encode(self, image: torch.Tensor) -> DiagonalGaussian:
        """(B, H, W, 3) NHWC images → distribution over (B, h, w, C) latents."""
        x = image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        moments = _conv(self.quant_conv, self.encoder(x))
        return DiagonalGaussian.from_parameters(moments.permute(0, 2, 3, 1))

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """(B, h, w, C) NHWC latents (unscaled) → (B, H, W, 3) images."""
        z = latent.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.decoder(_conv(self.post_quant_conv, z)).permute(0, 2, 3, 1).contiguous()

    def encode_image(self, image: torch.Tensor, mode: Optional[str] = "mode"):
        """``mode="mode"``: the scaled latent mean, (B, h, w, C);
        ``mode=None``: the distribution with its *mean* scaled and its
        logvar not (the reference's KL training quirk,
        ``AutoencoderKL.py:34-38``)."""
        dist = self.encode(image)
        if mode == "mode":
            return (dist.mode() * SD_LATENT_SCALE).contiguous()
        if mode is None:
            return DiagonalGaussian(dist.mean * SD_LATENT_SCALE, dist.logvar)
        raise NotImplementedError(mode)

    def decode_latent(self, latent: torch.Tensor) -> torch.Tensor:
        """Scaled (B, h, w, C) latents → (B, H, W, 3) images."""
        return self.decode(latent / SD_LATENT_SCALE)
