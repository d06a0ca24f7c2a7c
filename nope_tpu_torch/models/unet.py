"""The default pose-conditioned U-Net (``nope_tpu/models/unet.py``).

NCHW module with the reference's state-dict names (``downs.{i}.{0..3}``,
``mid_*``, ``ups.{i}.{0..3}``, ``final_conv.{0,1}``), which
``nope_tpu.training.port.port_pose_unet`` maps.  The reference's
``final_conv.0`` ResnetBlock carries an ``mlp`` it never calls; it is
left out here, as the port tool drops it.

Architecture (u_net_dim=192, dim_mults=(1,2,4,8) by default): init
conv3x3; 4 down stages [ResnetBlock, ResnetBlock, linear attention,
HardDownsample] (the last uses a conv3x3); a bottleneck
ResnetBlock / attention / ResnetBlock run twice when
``double_bottleneck``; 4 mirrored up stages with skip concatenation; a
final ResnetBlock on concat(x, r) and a 1x1 conv to the latent width
(``out_dim`` channels when given: 2C for the Gaussian-KL loss).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from nope_tpu_torch.models.blocks import (
    HardDownsample,
    HardUpsample,
    PoseMLP,
    ResidualPreNormAttention,
    ResnetBlock,
)


class PoseUNet(nn.Module):
    def __init__(
        self,
        u_net_dim: int = 192,
        channels: int = 4,
        rot_representation_dim: int = 6,
        pose_mlp_name: str = "single_layer",
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        resnet_block_groups: int = 8,
        double_bottleneck: bool = True,
        out_dim: Optional[int] = None,
    ):
        super().__init__()
        self.rot_representation_dim = rot_representation_dim
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
            is_last = ind >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                block(dim_in, dim_in),
                block(dim_in, dim_in),
                ResidualPreNormAttention(dim_in, linear=True),
                nn.Conv2d(dim_in, dim_out, 3, padding=1) if is_last
                else HardDownsample(dim_in, dim_out),
            ]))

        mid_dim = dims[-1]
        self.mid_block1 = block(mid_dim, mid_dim)
        self.mid_attn = ResidualPreNormAttention(mid_dim, linear=False)
        self.mid_block2 = block(mid_dim, mid_dim)

        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            is_last = ind == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                block(dim_out + dim_in, dim_out),
                block(dim_out + dim_in, dim_out),
                ResidualPreNormAttention(dim_out, linear=True),
                nn.Conv2d(dim_out, dim_in, 3, padding=1) if is_last
                else HardUpsample(dim_out, dim_in),
            ]))

        self.final_res_block = block(u_net_dim * 2, u_net_dim)
        self.final_conv = nn.Sequential(
            ResnetBlock(u_net_dim, u_net_dim, time_emb_dim=None, groups=groups),
            nn.Conv2d(u_net_dim, channels if out_dim is None else out_dim, 1),
        )

    def forward(self, x: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) latents; pose: (B, rot_representation_dim)."""
        c = self.pose_mlp(pose)
        x = self.init_conv(x.contiguous(memory_format=torch.channels_last))
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
