"""LDM-style pose-conditioned U-Net (``nope_tpu/models/ldm_unet.py``).

NCHW modules with the reference's state-dict names (the Stable-Diffusion
``UNetModel`` under ``UNetModelPose``: ``input_blocks.N.M``,
``middle_block.M``, ``output_blocks.N.M``, ``out.{0,2}``, ``pose_mlp``),
which ``nope_tpu.training.port.port_ldm_unet`` maps.  The pose embedding
is a single cross-attention context token; the diffusion timestep path
is off: every ResBlock's embedding is a zero vector (only the embedding
layers' biases act) unless ``injecting_condition_twice`` maps the pose
into it too (``pose_mlp_timesteps``).  The reference's unused
``time_embed`` MLP is not built, as the port tool drops it.

Everything here is plain PyTorch (cuDNN convs, GroupNorm, matmul
attention), as JAX computes these blocks outside any Pallas kernel, but
for the res blocks' GroupNorms in bf16 on the card outside grad mode
(the evaluation sweep, serving): there the activations stay channels-last
through the hand-written GroupNorm + SiLU pair
(``fused_resnet.group_norm_film_silu_nhwc``, the embedding or the FiLM
folded in), so cuDNN's convs read and write NHWC with no layout
transposes; the counter ``ldm_res.nhwc_norms`` (``utils.profiling``)
counts those GroupNorms (two a block).  The
attention is written as JAX writes it (scores, softmax, product), so a
self-attention over 32x32 latents holds heads x 1024² scores per item:
stream large template sweeps in chunks (``retrieve_streaming``).

Defaults mirror ``configs/model_ldm.yaml``: 32x32x4 latents,
model_channels 256, channel_mult (1, 2, 4), attention at every
downsampling factor, transformer depth 1, context_dim 512.  Layers that
JAX initialises to zero (each ResBlock's last conv, each transformer's
``proj_out``, the output conv) are marked by ``zero_module``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nope_tpu_torch.models.blocks import PoseMLP, nchw, nhwc, zero_module
from nope_tpu_torch.ops import fused_resnet as fr
from nope_tpu_torch.utils import profiling


class LDMResBlock(nn.Module):
    """GN32 → SiLU → conv / + emb (or FiLM with ``use_scale_shift_norm``) /
    GN32 → SiLU → zero conv, plus the skip; ``up`` / ``down`` resample h
    and x by nearest 2x repeat / 2x2 average pooling before the first conv."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False):
        super().__init__()
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.in_layers = nn.Sequential(
            nn.GroupNorm(32, channels, eps=1e-5), nn.SiLU(), nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, out_channels * (2 if use_scale_shift_norm else 1)))
        self.out_layers = nn.Sequential(
            nn.GroupNorm(32, out_channels, eps=1e-5), nn.SiLU(), nn.Identity(),
            zero_module(nn.Conv2d(out_channels, out_channels, 3, padding=1)))
        self.skip_connection = nn.Conv2d(channels, out_channels, 1) if channels != out_channels else nn.Identity()

    def _resample(self, t: torch.Tensor) -> torch.Tensor:
        if self.up:
            return F.interpolate(t, scale_factor=2, mode="nearest")
        if self.down:
            return F.avg_pool2d(t, 2)
        return t

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if self._channels_last_routes(x, emb):
            profiling.count("ldm_res.nhwc_norms", 2)  # its two GroupNorms, on the pair
            return self._forward_channels_last(x, emb)
        h = self.in_layers[1](self.in_layers[0](x))
        if self.up or self.down:
            h, x = self._resample(h), self._resample(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers(emb)[:, :, None, None]
        norm, rest = self.out_layers[0], self.out_layers[1:]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = rest(norm(h) * (1 + scale) + shift)
        else:
            h = rest(norm(h + emb_out))
        return self.skip_connection(x) + h

    def _channels_last_routes(self, x: torch.Tensor, emb: torch.Tensor) -> bool:
        """Whether :meth:`forward` takes :meth:`_forward_channels_last`
        (``fused_resnet.channels_last_norms_route``); in grad mode never, so
        refinement and training keep the plain ops and their gradients."""
        norms = (self.in_layers[0], self.out_layers[0])
        return fr.channels_last_norms_route(x.dtype, x.device.type, torch.is_grad_enabled(),
                                            x.is_contiguous(memory_format=torch.channels_last),
                                            tuple(n.num_channels for n in norms), norms[0].num_groups)

    def _forward_channels_last(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` of a channels-last x, every activation kept
        channels-last: each GroupNorm with its SiLU, and the embedding or
        the FiLM, by ``fused_resnet.group_norm_film_silu_nhwc``, the first
        conv's bias added there with the embedding (so no pass of its own);
        the convs on channels-last operands; the skip added into the second
        conv's output in place (no gradient flows here)."""
        norm1, norm2, conv1 = self.in_layers[0], self.out_layers[0], self.in_layers[2]
        h = nchw(fr.group_norm_film_silu_nhwc(nhwc(x), norm1.weight, norm1.bias, norm1.num_groups, norm1.eps))
        if self.up or self.down:
            h, x = self._resample(h), self._resample(x)
        h = _conv_channels_last(conv1, h, bias=False)
        emb_out = self.emb_layers(emb)
        if self.use_scale_shift_norm:
            cond = {"addend": conv1.bias.float().expand(len(emb_out), -1).contiguous(), "film": emb_out}
        else:
            cond = {"addend": emb_out.float() + conv1.bias.float()}
        h = nchw(fr.group_norm_film_silu_nhwc(nhwc(h), norm2.weight, norm2.bias, norm2.num_groups, norm2.eps, **cond))
        h = _conv_channels_last(self.out_layers[3], h)
        skip = x if isinstance(self.skip_connection, nn.Identity) else _conv_channels_last(self.skip_connection, x)
        return h.add_(skip)


def _conv_channels_last(conv: nn.Conv2d, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    """``conv(x)`` (without its bias where ``bias`` is False) with its
    weight held channels-last once (``fused_resnet.packed_weight``), where
    x is channels-last."""
    return F.conv2d(x, fr.packed_weight(conv.weight, "channels_last"), conv.bias if bias else None, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


class LDMCrossAttention(nn.Module):
    """Multi-head attention over tokens (B, n, dim); self-attention when
    ``context`` is None, else keys and values from ``context`` (B, m, d_ctx)."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Identity())

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        b, n, _ = x.shape
        m = context.shape[1]
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head).transpose(1, 2)  # (b, h, n, d)
        k = self.to_k(context).reshape(b, m, self.heads, self.dim_head).transpose(1, 2)
        v = self.to_v(context).reshape(b, m, self.heads, self.dim_head).transpose(1, 2)
        sim = torch.matmul(q, k.transpose(-1, -2)) * self.dim_head**-0.5  # (b, h, n, m)
        attn = torch.softmax(sim, dim=-1)
        del sim
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out)


class GEGLU(nn.Module):
    """Linear to 2·inner, then h · GELU(gate) (exact GELU)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class LDMFeedForward(nn.Module):
    """GEGLU feed-forward, ``net`` = [GEGLU, dropout (identity), Linear]."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class LDMTransformerBlock(nn.Module):
    """Self-attention, cross-attention to the context, GEGLU feed-forward,
    each pre-normed by a LayerNorm of Flax's epsilon (1e-6) and residual."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.attn1 = LDMCrossAttention(dim, dim, heads, dim_head)
        self.ff = LDMFeedForward(dim)
        self.attn2 = LDMCrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class LDMSpatialTransformer(nn.Module):
    """GN32 (eps 1e-6) → 1x1 conv in → tokens → transformer blocks →
    zero 1x1 conv out, plus the input."""

    def __init__(self, channels: int, context_dim: int, heads: int, dim_head: int, depth: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [LDMTransformerBlock(inner, context_dim, heads, dim_head) for _ in range(depth)])
        self.proj_out = zero_module(nn.Conv2d(inner, channels, 1))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        t = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, -1)
        for block in self.transformer_blocks:
            t = block(t, context)
        t = t.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        return x + self.proj_out(t)  # x first: the sum keeps x's layout (channels-last) for the res blocks


class LDMDownsample(nn.Module):
    """conv3x3 stride 2 (``op``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class LDMUpsample(nn.Module):
    """Nearest 2x repeat, then conv3x3 (``conv``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class EmbedSequential(nn.Sequential):
    """The reference's ``TimestepEmbedSequential``: ResBlocks take the
    embedding, transformers the context, anything else the input alone."""

    def forward(self, x: torch.Tensor, emb: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        for module in self:
            if isinstance(module, LDMResBlock):
                x = module(x, emb)
            elif isinstance(module, LDMSpatialTransformer):
                x = module(x, context)
            else:
                x = module(x)
        return x


def skip_channels(model_channels: int, channel_mult: Sequence[int], num_res_blocks: int) -> list:
    """Channels of every skip the input side pushes, in push order."""
    chs = [model_channels]
    for level, mult in enumerate(channel_mult):
        chs += [model_channels * mult] * num_res_blocks
        if level != len(channel_mult) - 1:
            chs.append(model_channels * mult)
    return chs


class LDMPoseUNet(nn.Module):
    """UNetModelPose: the LDM U-Net with a pose-token cross-attention."""

    def __init__(
        self,
        in_channels: int = 4,
        out_channels: int = 4,
        model_channels: int = 256,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4),
        num_head_channels: int = 32,
        context_dim: int = 512,
        transformer_depth: int = 1,
        rot_representation_dim: int = 6,
        pose_mlp_name: str = "single_layer",
        injecting_condition_twice: bool = False,
    ):
        super().__init__()
        self.rot_representation_dim = rot_representation_dim
        self.time_embed_dim = emb = model_channels * 4
        if injecting_condition_twice:
            self.pose_mlp_timesteps = PoseMLP(rot_representation_dim, emb, pose_mlp_name, posenc_trim=True)
        else:
            self.pose_mlp_timesteps = None
        self.pose_mlp = PoseMLP(rot_representation_dim, context_dim, pose_mlp_name, posenc_trim=True)

        def attn(ch):
            return LDMSpatialTransformer(ch, context_dim, ch // num_head_channels, num_head_channels,
                                         transformer_depth)

        self.input_blocks = nn.ModuleList([EmbedSequential(nn.Conv2d(in_channels, model_channels, 3, padding=1))])
        ch, ds = model_channels, 1
        for level, mult in enumerate(channel_mult):
            out_ch = model_channels * mult
            for _ in range(num_res_blocks):
                mods = [LDMResBlock(ch, emb, out_ch)]
                ch = out_ch
                if ds in attention_resolutions:
                    mods.append(attn(ch))
                self.input_blocks.append(EmbedSequential(*mods))
            if level != len(channel_mult) - 1:
                self.input_blocks.append(EmbedSequential(LDMDownsample(ch)))
                ds *= 2

        self.middle_block = EmbedSequential(LDMResBlock(ch, emb, ch), attn(ch), LDMResBlock(ch, emb, ch))

        skips = skip_channels(model_channels, channel_mult, num_res_blocks)
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            out_ch = model_channels * mult
            for i in range(num_res_blocks + 1):
                mods = [LDMResBlock(ch + skips.pop(), emb, out_ch)]
                ch = out_ch
                if ds in attention_resolutions:
                    mods.append(attn(ch))
                if level and i == num_res_blocks:
                    mods.append(LDMUpsample(ch))
                    ds //= 2
                self.output_blocks.append(EmbedSequential(*mods))

        self.out = nn.Sequential(nn.GroupNorm(32, ch, eps=1e-5), nn.SiLU(),
                                 zero_module(nn.Conv2d(ch, out_channels, 3, padding=1)))

    def forward(self, x: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) latents; pose: (B, rot_representation_dim)."""
        if self.pose_mlp_timesteps is not None:
            emb = self.pose_mlp_timesteps(pose)
        else:
            emb = torch.zeros(x.shape[0], self.time_embed_dim, dtype=x.dtype, device=x.device)
        context = self.pose_mlp(pose)[:, None, :]
        h = x.contiguous(memory_format=torch.channels_last)
        hs = []
        for module in self.input_blocks:
            h = module(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for module in self.output_blocks:
            h = module(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h)
