"""The U-Net's ResnetBlock as one op (``nope_tpu/ops/experimental/fused_resnet.py``).

    a   = SiLU(GN(conv3x3(x) + b1)) + emb
    out = SiLU(GN(conv3x3(a) + b2)) + (conv1x1(x) + res_b  or  x)

GroupNorm has ``groups`` groups, per-sample statistics and an affine.
Layout is NHWC at the boundary, as the JAX op: x (B, H, W, Cin), emb
(B, Co).  Parameters are a dict with the JAX op's keys (w1/b1/g1/be1,
w2/b2/g2/be2, optional res_w/res_b) holding the PyTorch modules'
tensors: conv weights OIHW, as ``nn.Conv2d`` stores them.

:func:`resnet_block` runs the K3 CUDA kernels (``csrc/fused_resnet.cu``)
for CUDA tensors and :func:`resnet_block_plain` for CPU tensors.
:func:`fused_resnet_block` adds the gradient: its backward recomputes
through the plain version, as the JAX op's custom VJP does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nope_tpu_torch.ops import _build

Params = Dict[str, torch.Tensor]
_KEYS = ("w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2", "res_w", "res_b")


def resnet_block_plain(
    x: torch.Tensor, emb: Optional[torch.Tensor], params: Params, groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The plain PyTorch version of K3, in x's dtype."""
    xc = x.permute(0, 3, 1, 2)
    h = F.conv2d(xc, params["w1"], params["b1"], padding=1)
    h = F.silu(F.group_norm(h, groups, params["g1"], params["be1"], eps))
    if emb is not None:
        h = h + emb[:, :, None, None]
    h = F.conv2d(h, params["w2"], params["b2"], padding=1)
    h = F.silu(F.group_norm(h, groups, params["g2"], params["be2"], eps))
    res = F.conv2d(xc, params["res_w"], params["res_b"]) if "res_w" in params else xc
    return (h + res).permute(0, 2, 3, 1)


def _check(x: torch.Tensor, emb: Optional[torch.Tensor], params: Params, groups: int):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, _, _, c_in = x.shape
    c_out = params["w1"].shape[0]
    if tuple(params["w1"].shape) != (c_out, c_in, 3, 3):
        raise ValueError(f"w1 {tuple(params['w1'].shape)} is not ({c_out}, {c_in}, 3, 3)")
    if tuple(params["w2"].shape) != (c_out, c_out, 3, 3):
        raise ValueError(f"w2 {tuple(params['w2'].shape)} is not ({c_out}, {c_out}, 3, 3)")
    if "res_w" not in params and c_in != c_out:
        raise ValueError("channel change requires res_w")
    if "res_w" in params and tuple(params["res_w"].shape) != (c_out, c_in, 1, 1):
        raise ValueError(f"res_w {tuple(params['res_w'].shape)} is not ({c_out}, {c_in}, 1, 1)")
    if c_out % groups:
        raise ValueError(f"{c_out} channels do not split into {groups} groups")
    if emb is not None and tuple(emb.shape) != (b, c_out):
        raise ValueError(f"emb {tuple(emb.shape)} is not ({b}, {c_out})")
    return c_in, c_out


def resnet_block(
    x: torch.Tensor, emb: Optional[torch.Tensor], params: Params, groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """K3: the whole ResnetBlock, (B, H, W, Cin) → (B, H, W, Co) in x's dtype."""
    c_in, c_out = _check(x, emb, params, groups)
    if x.device.type == "cpu":
        return resnet_block_plain(x, emb, params, groups, eps)
    _build.check_cuda("x", x)
    for name, t in [("emb", emb), *params.items()]:
        if t is None:
            continue
        _build.check_cuda(name, t)
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} must share x's dtype and device")
    b, h, w, _ = x.shape
    dev, dt = x.device, _build.DTYPE_CODES[x.dtype]
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty(b, h, w, c_out, dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    # (Co, Cin, 3, 3) → (3, 3, Cin, Co): the GEMM's (K, Co) operand
    w1 = params["w1"].permute(2, 3, 1, 0).contiguous()
    w2 = params["w2"].permute(2, 3, 1, 0).contiguous()
    conv = torch.empty(b, h, w, c_out, **f32)
    act = torch.empty(b, h, w, c_out, **f32)
    mean1, rstd1, mean2, rstd2 = torch.empty(4, b * groups, **f32)

    _build.launch("nope_conv_nhwc", dev, x.data_ptr(), w1.data_ptr(), params["b1"].data_ptr(),
                  conv.data_ptr(), b, h, w, c_in, c_out, 3, dt, dt)
    _build.launch("nope_group_stats", dev, conv.data_ptr(), mean1.data_ptr(), rstd1.data_ptr(),
                  b, h * w, c_out, groups, eps)
    _build.launch("nope_gn_silu", dev, conv.data_ptr(), mean1.data_ptr(), rstd1.data_ptr(),
                  params["g1"].data_ptr(), params["be1"].data_ptr(), dt,
                  None if emb is None else emb.data_ptr(), dt, None, 0,
                  act.data_ptr(), 0, b, h * w, c_out, groups)
    _build.launch("nope_conv_nhwc", dev, act.data_ptr(), w2.data_ptr(), params["b2"].data_ptr(),
                  conv.data_ptr(), b, h, w, c_out, c_out, 3, 0, dt)
    _build.launch("nope_group_stats", dev, conv.data_ptr(), mean2.data_ptr(), rstd2.data_ptr(),
                  b, h * w, c_out, groups, eps)
    if "res_w" in params:
        # the 1x1 projection reuses `act`: the second conv, earlier on
        # the stream, has finished reading it
        res_w = params["res_w"].reshape(c_out, c_in).t().contiguous()
        _build.launch("nope_conv_nhwc", dev, x.data_ptr(), res_w.data_ptr(),
                      params["res_b"].data_ptr(), act.data_ptr(), b, h, w, c_in, c_out, 1, dt, dt)
        res, res_dt = act, 0
    else:
        res, res_dt = x, dt
    _build.launch("nope_gn_silu", dev, conv.data_ptr(), mean2.data_ptr(), rstd2.data_ptr(),
                  params["g2"].data_ptr(), params["be2"].data_ptr(), dt, None, 0,
                  res.data_ptr(), res_dt, out.data_ptr(), dt, b, h * w, c_out, groups)
    resnet_block.launches += 1
    return out


resnet_block.launches = 0


class _ResnetBlockFn(torch.autograd.Function):
    """K3 forward; backward by recomputing the plain version."""

    @staticmethod
    def forward(ctx, groups, eps, x, emb, *ps):
        ctx.groups, ctx.eps = groups, eps
        ctx.save_for_backward(x, emb, *ps)
        return resnet_block(x, emb, {k: p for k, p in zip(_KEYS, ps) if p is not None}, groups, eps)

    @staticmethod
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [
                None if t is None else t.detach().requires_grad_(need)
                for t, need in zip(inputs, ctx.needs_input_grad[2:])
            ]
            params = {k: p for k, p in zip(_KEYS, leaves[2:]) if p is not None}
            out = resnet_block_plain(leaves[0], leaves[1], params, ctx.groups, ctx.eps)
            wrt = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad) if wrt else ())
        return (None, None, *[
            next(grads) if t is not None and t.requires_grad else None for t in leaves
        ])


def fused_resnet_block(
    x: torch.Tensor, emb: Optional[torch.Tensor], params: Params, groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """ResnetBlock forward through :func:`resnet_block`, with exact
    gradients through the plain version."""
    return _ResnetBlockFn.apply(groups, eps, x, emb, *[params.get(k) for k in _KEYS])
