"""The default pose-conditioned U-Net in plain PyTorch, float32: a frozen
copy of the program's ``models/unet.py`` and ``models/blocks.py`` with
the reference's state-dict names, so one seeded state dict loads into
both.  Every ResnetBlock and linear attention is the plain arithmetic
of the kernels it stands for (NCHW, cuDNN convs, GroupNorm, einsum).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Block(nn.Module):
    """conv3x3 → GroupNorm → SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.norm(self.proj(x)))


class ResnetBlock(nn.Module):
    """``h = block1(x) + Linear(SiLU(cond)); h = block2(h); h + res_conv(x)``."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None, groups: int = 8):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out))
                    if time_emb_dim is not None else None)
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.block1(x)
        if self.mlp is not None and cond is not None:
            h = h + self.mlp(cond)[:, :, None, None]
        h = self.block2(h)
        return h + (x if self.res_conv is None else self.res_conv(x))


class LinearAttention(nn.Module):
    """softmax(q over channels)·scale, softmax(k over tokens), context = kᵀv,
    out = q·context, then 1x1 conv + GroupNorm(1)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1), nn.GroupNorm(1, dim, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hh, ww = x.shape
        q, k, v = (t.reshape(b, self.heads, self.dim_head, hh * ww) for t in self.to_qkv(x).chunk(3, dim=1))
        q = torch.softmax(q, dim=-2) * self.dim_head**-0.5
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(b, self.heads * self.dim_head, hh, ww))


class Attention(nn.Module):
    """Full spatial self-attention (the bottleneck's)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hh, ww = x.shape
        q, k, v = (t.reshape(b, self.heads, self.dim_head, hh * ww) for t in self.to_qkv(x).chunk(3, dim=1))
        sim = torch.matmul((q * self.dim_head**-0.5).transpose(-1, -2), k)
        attn = torch.softmax(sim, dim=-1)
        out = torch.matmul(attn, v.transpose(-1, -2))
        return self.to_out(out.permute(0, 1, 3, 2).reshape(b, self.heads * self.dim_head, hh, ww))


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = nn.GroupNorm(1, dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class ResidualPreNormAttention(nn.Module):
    def __init__(self, dim: int, linear: bool = True):
        super().__init__()
        self.fn = _PreNorm(dim, (LinearAttention if linear else Attention)(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x) + x


class HardDownsample(nn.Sequential):
    """Pixel-unshuffle + 1x1 conv."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.PixelUnshuffle(2), nn.Conv2d(dim * 4, dim_out, 1))


class HardUpsample(nn.Sequential):
    """Nearest-neighbour 2x upsample + conv3x3."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"), nn.Conv2d(dim, dim_out, 3, padding=1))


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int, max_dim: Optional[int] = None):
        super().__init__()
        self.dim, self.max_dim = dim, max_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        emb_scale = math.log(10000) / (half_dim - 1)
        freqs = torch.exp(torch.arange(half_dim, device=x.device, dtype=torch.float32) * -emb_scale)
        emb = (x[:, :, None] * freqs.to(x.dtype)[None, None, :]).reshape(x.shape[0], -1)
        emb = torch.cat((torch.sin(emb), torch.cos(emb)), dim=-1)
        return emb if self.max_dim is None else emb[:, : self.max_dim]


class PoseMLP(nn.Sequential):
    """Pose → conditioning: ``single_layer``, ``two_layers`` or ``posEncoding``."""

    def __init__(self, in_dim: int, out_dim: int, kind: str = "single_layer", posenc_trim: bool = False):
        if kind == "single_layer":
            layers = [nn.Linear(in_dim, out_dim)]
        elif kind == "two_layers":
            layers = [nn.Linear(in_dim, out_dim), nn.GELU(), nn.Linear(out_dim, out_dim)]
        elif kind == "posEncoding":
            layers = [SinusoidalPosEmb(out_dim // 6 + 1, max_dim=out_dim) if posenc_trim
                      else SinusoidalPosEmb(out_dim // 6)]
        else:
            raise ValueError(f"unknown pose_mlp kind {kind!r}")
        super().__init__(*layers)


class PoseUNet(nn.Module):
    """init conv; 4 down stages [ResnetBlock, ResnetBlock, linear attention,
    downsample]; the bottleneck (twice with ``double_bottleneck``); 4 up
    stages with skips; a final ResnetBlock on concat(x, r) and a 1x1 conv."""

    def __init__(
        self,
        u_net_dim: int = 192,
        channels: int = 4,
        rot_representation_dim: int = 6,
        pose_mlp_name: str = "single_layer",
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        resnet_block_groups: int = 8,
        double_bottleneck: bool = True,
    ):
        super().__init__()
        self.double_bottleneck = double_bottleneck
        classes_dim = u_net_dim * 4
        dims = [u_net_dim] + [u_net_dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        groups = resnet_block_groups

        def block(dim_in, dim_out):
            return ResnetBlock(dim_in, dim_out, time_emb_dim=classes_dim, groups=groups)

        self.pose_mlp = PoseMLP(rot_representation_dim, classes_dim, kind=pose_mlp_name)
        self.init_conv = nn.Conv2d(channels, u_net_dim, 3, padding=1)
        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            last = ind >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                block(dim_in, dim_in), block(dim_in, dim_in), ResidualPreNormAttention(dim_in, linear=True),
                nn.Conv2d(dim_in, dim_out, 3, padding=1) if last else HardDownsample(dim_in, dim_out),
            ]))
        mid_dim = dims[-1]
        self.mid_block1 = block(mid_dim, mid_dim)
        self.mid_attn = ResidualPreNormAttention(mid_dim, linear=False)
        self.mid_block2 = block(mid_dim, mid_dim)
        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            last = ind == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                block(dim_out + dim_in, dim_out), block(dim_out + dim_in, dim_out),
                ResidualPreNormAttention(dim_out, linear=True),
                nn.Conv2d(dim_out, dim_in, 3, padding=1) if last else HardUpsample(dim_out, dim_in),
            ]))
        self.final_res_block = block(u_net_dim * 2, u_net_dim)
        self.final_conv = nn.Sequential(ResnetBlock(u_net_dim, u_net_dim, None, groups),
                                        nn.Conv2d(u_net_dim, channels, 1))

    def forward(self, x: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) latents; pose: (B, rot_representation_dim)."""
        c = self.pose_mlp(pose)
        x = self.init_conv(x)
        r = x
        hs = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, c)
            hs.append(x)
            x = attn(block2(x, c))
            hs.append(x)
            x = down(x)
        for _ in range(2 if self.double_bottleneck else 1):
            x = self.mid_block2(self.mid_attn(self.mid_block1(x, c)), c)
        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat((x, hs.pop()), dim=1), c)
            x = attn(block2(torch.cat((x, hs.pop()), dim=1), c))
            x = up(x)
        x = self.final_res_block(torch.cat((x, r), dim=1), c)
        return self.final_conv(x)
