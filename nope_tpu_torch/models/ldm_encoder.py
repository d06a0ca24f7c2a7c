"""LDM half-U-Net encoder and CLIP-style attention pooling
(``nope_tpu/models/ldm_encoder.py``).

NCHW modules with the reference's state-dict names (``EncoderUNetModel``
and ``AttentionPool2d`` of the vendored ``openaimodel.py``), which
``nope_tpu.training.port.port_ldm_encoder_unet`` maps.  No config
reaches them (guided-diffusion uses this half U-Net as the noisy
classifier of classifier guidance); the port has them because the JAX
package does.  Unlike the pose U-Nets, the timestep conditioning is
real: ``forward(x, timesteps)``.  Plain PyTorch, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from nope_tpu_torch.models.adm_unet import ADMAttentionBlock, qkv_attention
from nope_tpu_torch.models.blocks import timestep_embedding, zero_module
from nope_tpu_torch.models.ldm_unet import EmbedSequential, LDMDownsample, LDMResBlock


class AttentionPool2d(nn.Module):
    """Prepend the mean token, add a learned positional embedding
    (``positional_embedding``: (C, spacial² + 1), the reference's layout),
    one new-order QKV attention pass, and return the attended mean token
    projected to ``output_dim``."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_head_channels: int,
                 output_dim: Optional[int] = None):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim**2 + 1) / embed_dim**0.5)
        self.qkv_proj = nn.Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = nn.Conv1d(embed_dim, output_dim or embed_dim, 1)
        self.num_heads = embed_dim // num_head_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        t = x.reshape(b, c, -1)
        t = torch.cat([t.mean(dim=-1, keepdim=True), t], dim=-1)
        t = t + self.positional_embedding[None].to(t.dtype)
        out = self.c_proj(qkv_attention(self.qkv_proj(t), self.num_heads))
        return out[:, :, 0]


class LDMEncoderUNet(nn.Module):
    """The half U-Net with attention and a timestep embedding, and one of
    four heads (``pool``): ``adaptive`` (GN → SiLU → global mean → zero 1x1
    conv), ``attention`` (GN → SiLU → :class:`AttentionPool2d`, which needs
    ``image_size``, the input's side), ``spatial`` (every block's spatial
    mean, concatenated → MLP with ReLU) and ``spatial_v2`` (→ Linear →
    GN32 → SiLU → Linear)."""

    def __init__(
        self,
        out_channels: int,
        in_channels: int = 4,
        model_channels: int = 256,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4),
        num_heads: int = 1,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        pool: str = "adaptive",
        image_size: Optional[int] = None,
    ):
        super().__init__()
        if pool not in ("adaptive", "attention", "spatial", "spatial_v2"):
            raise ValueError(f"unexpected pool {pool!r}")
        self.model_channels, self.pool = model_channels, pool
        emb = model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb), nn.SiLU(), nn.Linear(emb, emb))

        def heads(ch):
            return num_heads if num_head_channels == -1 else ch // num_head_channels

        def res(ch, out_ch, down=False):
            return LDMResBlock(ch, emb, out_ch, use_scale_shift_norm=use_scale_shift_norm, down=down)

        self.input_blocks = nn.ModuleList([EmbedSequential(nn.Conv2d(in_channels, model_channels, 3, padding=1))])
        ch, ds = model_channels, 1
        feature_size = model_channels
        for level, mult in enumerate(channel_mult):
            out_ch = model_channels * mult
            for _ in range(num_res_blocks):
                mods = [res(ch, out_ch)]
                ch = out_ch
                if ds in attention_resolutions:
                    mods.append(ADMAttentionBlock(ch, heads(ch)))
                self.input_blocks.append(EmbedSequential(*mods))
                feature_size += ch
            if level != len(channel_mult) - 1:
                self.input_blocks.append(EmbedSequential(res(ch, ch, down=True) if resblock_updown
                                                         else LDMDownsample(ch)))
                ds *= 2
                feature_size += ch

        self.middle_block = EmbedSequential(res(ch, ch), ADMAttentionBlock(ch, heads(ch)), res(ch, ch))
        feature_size += ch

        if pool == "adaptive":
            self.out = nn.Sequential(nn.GroupNorm(32, ch, eps=1e-5), nn.SiLU(), nn.AdaptiveAvgPool2d((1, 1)),
                                     zero_module(nn.Conv2d(ch, out_channels, 1)), nn.Flatten())
        elif pool == "attention":
            if num_head_channels == -1 or image_size is None:
                raise ValueError("the attention pool needs num_head_channels and image_size")
            self.out = nn.Sequential(nn.GroupNorm(32, ch, eps=1e-5), nn.SiLU(),
                                     AttentionPool2d(image_size // ds, ch, num_head_channels, out_channels))
        elif pool == "spatial":
            self.out = nn.Sequential(nn.Linear(feature_size, 2048), nn.ReLU(), nn.Linear(2048, out_channels))
        else:
            self.out = nn.Sequential(nn.Linear(feature_size, 2048), nn.GroupNorm(32, 2048, eps=1e-5), nn.SiLU(),
                                     nn.Linear(2048, out_channels))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W); timesteps: (B,) → (B, out_channels)."""
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(x.dtype))
        spatial = self.pool.startswith("spatial")
        results = []
        h = x.contiguous(memory_format=torch.channels_last)
        for module in self.input_blocks:
            h = module(h, emb)
            if spatial:
                results.append(h.mean(dim=(2, 3)))
        h = self.middle_block(h, emb)
        if spatial:
            results.append(h.mean(dim=(2, 3)))
            return self.out(torch.cat(results, dim=-1))
        return self.out(h)
