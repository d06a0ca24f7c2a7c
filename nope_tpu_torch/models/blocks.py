"""Building blocks of the pose-conditioned U-Net (``nope_tpu/models/blocks.py``).

NCHW modules with the reference's state-dict names (lucidrains
``model_utils.py`` lineage), which ``nope_tpu.training.port`` maps.
Activations are kept channels-last in memory, so the NHWC views the
kernels take cost no copy.

``ResnetBlock`` always runs :func:`ops.fused_resnet.fused_resnet_block`
(K3) and ``LinearAttention`` always runs
:func:`ops.linear_attention.linear_attention` (K2): each op runs its
CUDA kernel for a CUDA tensor and its plain version for a CPU tensor,
and takes its gradient through the plain version.  ``Attention``, the
up/down-samplers, every 1x1 conv and the blocks no config's forward
reaches (``ConditionalResnetBlock``, ``DualConditionalResnetBlock``,
``ChannelLayerNorm``, ``ImagenCrossAttention``, ``timestep_embedding``)
stay plain PyTorch, as they were XLA ops in JAX.

A module whose weights JAX initialises to zero is marked by
:func:`zero_module`; the factory's seeded init keeps it at zero.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nope_tpu_torch.ops.fused_resnet import fused_resnet_block
from nope_tpu_torch.ops.linear_attention import linear_attention
from nope_tpu_torch.utils import profiling


def zero_module(module: nn.Module) -> nn.Module:
    """Mark ``module`` (a conv or linear) as zero-initialised, as JAX's
    ``_zero_init`` layers are: ``models.factory.init_weights`` zeroes its
    weight and bias instead of drawing them."""
    module.zero_init = True
    return module


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW → contiguous NHWC (a free view of a channels-last tensor)."""
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC → NCHW view in channels-last memory."""
    return x.permute(0, 3, 1, 2)


class Block(nn.Module):
    """conv3x3 → GroupNorm → (scale+1)·x + shift → SiLU.  ``ResnetBlock``
    hands its two Blocks' weights to the K3 op rather than calling them."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x: torch.Tensor, scale_shift=None) -> torch.Tensor:
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    """``h = block1(x) + Linear(SiLU(cond)); h = block2(h); h + res_conv(x)``,
    computed by the K3 op."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None, groups: int = 8):
        super().__init__()
        self.groups = groups
        self.mlp = (
            nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out))
            if time_emb_dim is not None else None
        )
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        with profiling.span("k3", facts=lambda: self._facts(x)):
            emb = self.mlp(cond) if self.mlp is not None and cond is not None else None
            params = {
                "w1": self.block1.proj.weight, "b1": self.block1.proj.bias,
                "g1": self.block1.norm.weight, "be1": self.block1.norm.bias,
                "w2": self.block2.proj.weight, "b2": self.block2.proj.bias,
                "g2": self.block2.norm.weight, "be2": self.block2.norm.bias,
            }
            if self.res_conv is not None:
                params["res_w"], params["res_b"] = self.res_conv.weight, self.res_conv.bias
            out = fused_resnet_block(nhwc(x), emb, params, self.groups, self.block1.norm.eps)
            return nchw(out)

    def _facts(self, x: torch.Tensor) -> dict:
        """The ``k3`` span's attributes: items, dtype and ``shape`` (h, w,
        cin, co, res, emb) of NCHW ``x``."""
        return dict(profiling.batch_facts(x), shape=(
            int(x.shape[2]), int(x.shape[3]), self.block1.proj.in_channels, self.block1.proj.out_channels,
            self.res_conv is not None, self.mlp is not None))


class ConditionalResnetBlock(nn.Module):
    """FiLM variant: concat(time, class) → SiLU → Linear(2·dim_out) →
    scale/shift inside block1; then block2 and the residual."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None,
                 classes_emb_dim: Optional[int] = None, groups: int = 8):
        super().__init__()
        cond_dim = (time_emb_dim or 0) + (classes_emb_dim or 0)
        self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(cond_dim, dim_out * 2)) if cond_dim else None
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x: torch.Tensor, time_emb: Optional[torch.Tensor] = None,
                class_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale_shift = None
        embs = [e for e in (time_emb, class_emb) if e is not None]
        if embs and self.mlp is not None:
            cond = self.mlp(torch.cat(embs, dim=-1))[:, :, None, None]
            scale_shift = cond.chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift))
        return h + (x if self.res_conv is None else self.res_conv(x))


class DualConditionalResnetBlock(nn.Module):
    """FiLM block conditioned on (time, class) embeddings and a reference
    feature map of ``ref_dim`` channels: the embedding MLP and a Block over
    the reference (``mlp_ref``) are summed into one scale/shift."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, classes_emb_dim: int, ref_dim: int,
                 groups: int = 8):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim + classes_emb_dim, dim_out * 2))
        self.mlp_ref = Block(ref_dim, dim_out * 2, groups)
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x: torch.Tensor, ref: Optional[torch.Tensor] = None,
                time_emb: Optional[torch.Tensor] = None,
                class_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale_shift = None
        if ref is not None and time_emb is not None and class_emb is not None:
            cond = self.mlp(torch.cat([time_emb, class_emb], dim=-1))[:, :, None, None]
            scale_shift = (cond + self.mlp_ref(ref)).chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift))
        return h + (x if self.res_conv is None else self.res_conv(x))


class LinearAttention(nn.Module):
    """softmax(q over channels)·scale, softmax(k over tokens),
    context = kᵀv, out = q·context (the K2 op), then 1x1 conv + GroupNorm(1)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1), nn.GroupNorm(1, dim, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hh, ww = x.shape
        # the k2 span's shape: (dim, tokens)
        with profiling.span("k2", facts=lambda: dict(profiling.batch_facts(x), shape=(int(x.shape[1]), hh * ww))):
            qkv = nhwc(self.to_qkv(x)).reshape(b, hh * ww, -1)
            out = linear_attention(qkv, self.heads, self.dim_head)
            return self.to_out(nchw(out.reshape(b, hh, ww, -1)))


class Attention(nn.Module):
    """Full spatial self-attention with the reference's max subtraction
    under no-grad, in plain matmul and softmax."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hh, ww = x.shape
        n = hh * ww
        q, k, v = (
            t.reshape(b, self.heads, self.dim_head, n)  # heads-major split
            for t in self.to_qkv(x).chunk(3, dim=1)
        )
        q = q * self.dim_head**-0.5
        sim = torch.matmul(q.transpose(-1, -2), k)  # (b, h, i, j)
        sim = sim - sim.amax(dim=-1, keepdim=True).detach()
        attn = torch.softmax(sim, dim=-1)
        out = torch.matmul(attn, v.transpose(-1, -2))  # (b, h, n, d)
        out = out.permute(0, 1, 3, 2).reshape(b, self.heads * self.dim_head, hh, ww)
        return self.to_out(out)


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = nn.GroupNorm(1, dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class ResidualPreNormAttention(nn.Module):
    """``Residual(PreNorm(dim, Attention))``: GroupNorm(1) → attention → +x.
    ``linear=True`` selects LinearAttention, else full Attention."""

    def __init__(self, dim: int, linear: bool = True, heads: int = 4, dim_head: int = 32):
        super().__init__()
        attn = (LinearAttention if linear else Attention)(dim, heads, dim_head)
        self.fn = _PreNorm(dim, attn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x) + x


class Downsample(nn.Conv2d):
    """Strided conv4x4/2 (the samplers of ``PoseUNet(use_hard_up_down=False)``)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(dim, dim_out, 4, stride=2, padding=1)


class Upsample(nn.ConvTranspose2d):
    """Transposed conv4x4/2, padding 1: a 2x upsample."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(dim, dim_out, 4, stride=2, padding=1)


class HardDownsample(nn.Sequential):
    """Pixel-unshuffle (reference channel order ``b c (h p1) (w p2) ->
    b (c p1 p2) h w``, which is ``F.pixel_unshuffle``'s) + 1x1 conv."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.PixelUnshuffle(2), nn.Conv2d(dim * 4, dim_out, 1))


class HardUpsample(nn.Sequential):
    """Nearest-neighbour 2x upsample + conv3x3."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         nn.Conv2d(dim, dim_out, 3, padding=1))


class SinusoidalPosEmb(nn.Module):
    """Per-component sinusoidal embedding of a pose vector, then
    sin/cat(cos), optionally trimmed to ``max_dim``."""

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
    """Pose → conditioning embedding: ``single_layer`` (default),
    ``two_layers`` (+GELU) or ``posEncoding``."""

    def __init__(self, in_dim: int, out_dim: int, kind: str = "single_layer",
                 posenc_trim: bool = False):
        if kind == "single_layer":
            layers = [nn.Linear(in_dim, out_dim)]
        elif kind == "two_layers":
            layers = [nn.Linear(in_dim, out_dim), nn.GELU(), nn.Linear(out_dim, out_dim)]
        elif kind == "posEncoding":
            if posenc_trim:
                layers = [SinusoidalPosEmb(out_dim // 6 + 1, max_dim=out_dim)]
            elif out_dim % 6:
                raise ValueError("out_dim must be divisible by 6 for posEncoding")
            else:
                layers = [SinusoidalPosEmb(out_dim // 6)]
        else:
            raise ValueError(f"unknown pose_mlp kind {kind!r}")
        super().__init__(*layers)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding (B,) → (B, dim) float32: cos then
    sin over ``dim // 2`` frequencies, a zero column when ``dim`` is odd."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=timesteps.device) / half)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class ChannelLayerNorm(nn.Module):
    """imagen-style LayerNorm over ``axis`` with a learned gain only:
    (x - mean) · rsqrt(var + eps) · g, eps 1e-5 in float32 and 1e-3
    otherwise; ``stable`` first divides by the (no-grad) max."""

    def __init__(self, dim: int, axis: int = -1, stable: bool = False):
        super().__init__()
        self.axis, self.stable = axis, stable
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stable:
            x = x / x.amax(dim=self.axis, keepdim=True).detach()
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        var = torch.var(x, dim=self.axis, unbiased=False, keepdim=True)
        mean = torch.mean(x, dim=self.axis, keepdim=True)
        shape = [1] * x.dim()
        shape[self.axis] = -1
        return (x - mean) * torch.rsqrt(var + eps) * self.g.reshape(shape)


class ImagenCrossAttention(nn.Module):
    """imagen-lineage cross-attention with a learned null key/value
    (classifier-free guidance) and cosine-similarity QK scaled by
    ``scale``.  No config's forward reaches it."""

    def __init__(self, dim: int, context_dim: Optional[int] = None, heads: int = 8, dim_head: int = 64,
                 scale: float = 8.0):
        super().__init__()
        self.heads, self.dim_head, self.scale = heads, dim_head, scale
        inner = heads * dim_head
        self.norm = ChannelLayerNorm(dim)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(context_dim or dim, inner * 2, bias=False)
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = nn.Sequential(nn.Linear(inner, dim, bias=False), ChannelLayerNorm(dim))

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        q = self.to_q(self.norm(x))
        k, v = self.to_kv(context).chunk(2, dim=-1)

        def heads_split(t):
            return t.reshape(b, -1, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads_split(q), heads_split(k), heads_split(v)
        nk, nv = (t.to(x.dtype).expand(b, self.heads, 1, self.dim_head) for t in self.null_kv[:, None, None])
        k, v = torch.cat([nk, k], dim=2), torch.cat([nv, v], dim=2)

        def l2norm(t):
            return t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp(min=1e-12)

        q, k = l2norm(q) * self.q_scale, l2norm(k) * self.k_scale
        sim = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        if mask is not None:
            mask = F.pad(mask, (1, 0), value=True)
            sim = sim.masked_fill(~mask[:, None, None, :], torch.finfo(sim.dtype).min)
        attn = torch.softmax(sim.float(), dim=-1).to(sim.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out)
