"""The U-Net's ResnetBlock as one op (``nope_tpu/ops/experimental/fused_resnet.py``).

    a   = SiLU(GN(conv3x3(x) + b1)) + emb
    out = SiLU(GN(conv3x3(a) + b2)) + (conv1x1(x) + res_b  or  x)

GroupNorm has ``groups`` groups, per-sample statistics and an affine.
Layout is NHWC at the boundary, as the JAX op: x (B, H, W, Cin), emb
(B, Co).  Parameters are a dict with the JAX op's keys (w1/b1/g1/be1,
w2/b2/g2/be2, optional res_w/res_b) holding the PyTorch modules'
tensors: conv weights OIHW, as ``nn.Conv2d`` stores them.

:func:`resnet_block` runs the K3 CUDA kernels (``csrc/fused_resnet.cu``)
for CUDA tensors and :func:`resnet_block_plain` for CPU tensors.  In
bfloat16 its convs run on the tensor cores (``wgmma``) and the
GroupNorm statistics come from the convs' epilogue as per-tile partials
(:func:`gn_partials_plain` and :func:`gn_merge_plain` are their plain
versions); in float32, and for widths the tensor-core tiles do not take,
they run on the CUDA cores.  Conv weights are laid out for the kernels
once per parameter (:func:`packed_weight`).  :func:`fused_resnet_block`
adds the gradient: its backward recomputes through the plain version,
as the JAX op's custom VJP does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from nope_tpu_torch.ops import _build

Params = Dict[str, torch.Tensor]
_KEYS = ("w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2", "res_w", "res_b")
#: the tensor-core conv's N tile (whole GroupNorm groups when the group
#: width divides it) and K-slice (one tap, 64 channels)
TILE_N, SLICE_K = 192, 64
#: the tile heights (output pixels) the tensor-core conv is built for
TILE_M = (64, 192)
#: per parameter: (its storage key, {layout: pack}) -- see packed_weight
_PACKS = WeakIdKeyDictionary()


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


def packed_weight(w: torch.Tensor, layout: str) -> torch.Tensor:
    """Conv weight ``w`` (Co, Cin, kh, kw) in the layout a K3 kernel reads:

    - ``"co_k"``: (Co, kh·kw·Cin), K ordered (tap, ci): the tensor-core
      conv's B operand, K-major as ``wgmma`` reads it untransposed;
    - ``"k_co"``: (kh·kw·Cin, Co), the CUDA-core conv's operand.

    Made once per parameter and held, while the parameter lives, in a
    table keyed on the parameter object and checked against its storage,
    ``_version``, dtype and device: an in-place update (an optimizer
    step, ``copy_`` under no-grad, ``load_state_dict``, ``Module.to``)
    drops the parameter's packs and repacks, and a forward copies nothing.
    """
    key = (w.data_ptr(), w._version, w.dtype, w.device, tuple(w.shape))
    entry = _PACKS.get(w)
    if entry is None or entry[0] != key:
        entry = _PACKS[w] = (key, {})
    packs = entry[1]
    if layout in packs:
        return packs[layout]
    co, ci, kh, kw = w.shape
    flat = w.detach().permute(0, 2, 3, 1).reshape(co, kh * kw * ci)
    if layout == "co_k":
        packed = flat.contiguous()
    elif layout == "k_co":
        packed = flat.t().contiguous()
    else:
        raise ValueError(f"unknown layout {layout!r}")
    packs[layout] = packed
    return packed


class ConvPlan(NamedTuple):
    bm: int  # output rows (pixels) per tile, one of TILE_M
    splits: int  # K split over this many blocks, summed in order after
    segmax: int  # most samples one tile can touch (GroupNorm partials per group)


def conv_plan(m: int, hw: int, c_out: int, k_slices: int, sms: int) -> ConvPlan:
    """Tiling of the tensor-core conv of an (m, c_out) output with
    ``k_slices`` 64-deep K-slices, on a card with ``sms`` SMs: 192-row
    tiles (one block to an SM) or 64-row tiles (a 97 KB ring, two blocks
    to an SM), whichever costs less in waves × rows an SM computes per
    wave (192 on a tie: fewer bytes per operation).  64-row tiles that
    do not fill the card split K until they do, each split keeping at
    least 4 K-slices.  ``bm`` depends on (m, c_out) alone, so a block's
    two convs write partials of one layout."""
    n_tiles = -(-c_out // TILE_N)
    t64, t192 = -(-m // 64) * n_tiles, -(-m // 192) * n_tiles
    if -(-t192 // sms) * 192 <= -(-t64 // (2 * sms)) * 128:
        bm, splits = 192, 1
    else:
        bm, splits = 64, max(1, min(2 * sms // t64, k_slices // 4))
    return ConvPlan(bm, splits, min(bm, (bm - 2) // hw + 2))


def gn_partials_plain(h: torch.Tensor, hw: int, groups: int, bm: int) -> torch.Tensor:
    """The plain version of what the tensor-core conv's epilogue writes:
    for the pre-norm output ``h`` (M, Co), M = B·hw, per ``bm``-row tile
    and per (sample, group) the tile touches, (count, mean, M2) over the
    tile's rows of that sample and the group's channels.  Returns
    (ceil(M / bm), G, segmax, 3), slot s = sample − the tile's first."""
    m, c = h.shape
    segmax = min(bm, (bm - 2) // hw + 2)
    part = torch.zeros(-(-m // bm), groups, segmax, 3, dtype=torch.float32)
    for mt in range(part.shape[0]):
        m0, m1 = mt * bm, min(mt * bm + bm, m)
        for s, b in enumerate(range(m0 // hw, (m1 - 1) // hw + 1)):
            ra, rb = max(m0, b * hw), min(m1, (b + 1) * hw)
            seg = h[ra:rb].float().reshape(rb - ra, groups, c // groups).transpose(0, 1)
            seg = seg.reshape(groups, -1)
            mean = seg.mean(1)
            part[mt, :, s, 0] = seg.shape[1]
            part[mt, :, s, 1] = mean
            part[mt, :, s, 2] = ((seg - mean[:, None]) ** 2).sum(1)
    return part


def gn_merge_plain(part: torch.Tensor, batch: int, hw: int, bm: int, eps: float):
    """The plain version of ``gn_finalize``: per (sample, group), Chan's
    merge of its tiles' partials in tile order; returns (mean, rstd),
    each (batch·G,)."""
    groups = part.shape[1]
    mean = torch.empty(batch, groups)
    rstd = torch.empty(batch, groups)
    for b in range(batch):
        n = mu = m2 = torch.zeros(groups)
        for mt in range(b * hw // bm, ((b + 1) * hw - 1) // bm + 1):
            nb, mb, m2b = part[mt, :, b - mt * bm // hw].unbind(-1)
            nt = n + nb
            d = mb - mu
            mu = mu + d * (nb / nt)
            m2 = m2 + m2b + d * d * (n * nb / nt)
            n = nt
        mean[b], rstd[b] = mu, 1.0 / torch.sqrt(m2 / n + eps)
    return mean.reshape(-1), rstd.reshape(-1)


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


def _check_aligned(x: torch.Tensor, emb: Optional[torch.Tensor], params: Params) -> None:
    """The kernels read x (also the identity residual), emb and the
    GroupNorm shifts 4 channels at a time, x by 16-byte ``cp.async``."""
    for name, t in (("x", x), ("emb", emb), ("be1", params["be1"]), ("be2", params["be2"])):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned, got address {t.data_ptr():#x}")


def _tensor_core_fits(c_in: int, c_out: int, groups: int) -> bool:
    """Widths the bf16 tensor-core conv tiles: 64-channel K-slices, and
    GroupNorm groups that never straddle a 192-wide N tile."""
    return c_in % SLICE_K == 0 and c_out % 8 == 0 and TILE_N % (c_out // groups) == 0


class _Scratch:
    """One float32 allocation carved into regions (a block's launches take
    raw pointers, so one ``torch.empty`` serves all its intermediates);
    each region starts on a 256-byte boundary."""

    def __init__(self, device: torch.device, **sizes: int):
        offsets, total = {}, 0
        for name, n in sizes.items():
            offsets[name] = total
            total += -(-n // 64) * 64
        self.tensor = torch.empty(total, dtype=torch.float32, device=device)
        base = self.tensor.data_ptr()
        self.ptr = {name: base + 4 * off if sizes[name] else None for name, off in offsets.items()}


def _conv_wgmma(call, x_ptr, w, bias, out_ptr, part_ptr, ws_ptr, shape, ks, groups, plan) -> None:
    """One bf16 tensor-core conv (``ks`` = 3 with zero padding, or 1):
    x (B, H, W, Cin) bf16, ``w`` = ``packed_weight(·, "co_k")`` → out
    (B·H·W, Co) float32 + bias, and the tiles' GroupNorm partials
    ((ceil(M / plan.bm), G, plan.segmax, 3) float32) unless part_ptr is
    None; ws_ptr holds plan.splits·M·Co floats when K is split."""
    b, h, wd, c_in = shape
    call("nope_conv_wgmma", x_ptr, w.data_ptr(), bias.data_ptr(), _build.DTYPE_CODES[bias.dtype],
         out_ptr, part_ptr, ws_ptr, b, h, wd, c_in, w.shape[0], ks, groups, plan.bm, plan.splits,
         plan.segmax)


def _block_tensor_cores(x, emb, params, groups, eps, out):
    """bf16: three tensor-core convs, the GroupNorm statistics from their
    epilogues, ``act`` kept in bf16."""
    b, h, w, c_in = x.shape
    c_out, m, hw, dev = out.shape[-1], b * h * w, h * w, x.device
    sms = _build.sm_count(dev)
    plan1 = conv_plan(m, hw, c_out, 9 * c_in // SLICE_K, sms)
    plan2 = conv_plan(m, hw, c_out, 9 * c_out // SLICE_K, sms)
    plan_r = conv_plan(m, hw, c_out, c_in // SLICE_K, sms) if "res_w" in params else None
    splits = max(p.splits for p in (plan1, plan2, plan_r) if p is not None)
    mc = m * c_out
    scratch = _Scratch(
        dev, conv=mc, res=mc if plan_r else 0, ws=splits * mc if splits > 1 else 0,
        part=-(-m // plan1.bm) * groups * plan1.segmax * 3, mean=b * c_out, scale=b * c_out)
    ptr = scratch.ptr
    act = torch.empty(b, h, w, c_out, dtype=x.dtype, device=dev)
    dt = _build.DTYPE_CODES[x.dtype]
    w1, w2 = packed_weight(params["w1"], "co_k"), packed_weight(params["w2"], "co_k")

    with _build.launcher(dev) as call:

        def normalise(gamma, beta, emb_ptr, res_ptr, res_dt, dst):
            call("nope_gn_finalize", ptr["part"], gamma.data_ptr(), dt, ptr["mean"], ptr["scale"],
                 b, hw, c_out, groups, plan1.bm, plan1.segmax, eps)
            call("nope_gn_silu", ptr["conv"], ptr["mean"], ptr["scale"], beta.data_ptr(), dt,
                 emb_ptr, dt, res_ptr, res_dt, dst.data_ptr(), dt, b, hw, c_out, _build.grid_y(b))

        _conv_wgmma(call, x.data_ptr(), w1, params["b1"], ptr["conv"], ptr["part"], ptr["ws"],
                    x.shape, 3, groups, plan1)
        normalise(params["g1"], params["be1"], None if emb is None else emb.data_ptr(), None, 0, act)
        _conv_wgmma(call, act.data_ptr(), w2, params["b2"], ptr["conv"], ptr["part"], ptr["ws"],
                    act.shape, 3, groups, plan2)
        if plan_r is not None:
            _conv_wgmma(call, x.data_ptr(), packed_weight(params["res_w"], "co_k"), params["res_b"],
                        ptr["res"], None, ptr["ws"], x.shape, 1, groups, plan_r)
            res_ptr, res_dt = ptr["res"], 0
        else:
            res_ptr, res_dt = x.data_ptr(), dt
        normalise(params["g2"], params["be2"], None, res_ptr, res_dt, out)
    resnet_block.tensor_core_launches += 1


def _block_cuda_cores(x, emb, params, groups, eps, out):
    """float32 (exact: no TF32), and widths the tensor-core tiles do not
    take: the CUDA-core conv, two-pass statistics, float32 ``act``."""
    b, h, w, c_in = x.shape
    c_out, m, hw, dev = out.shape[-1], b * h * w, h * w, x.device
    dt = _build.DTYPE_CODES[x.dtype]
    scratch = _Scratch(dev, conv=m * c_out, act=m * c_out, mean=b * c_out, scale=b * c_out)
    ptr = scratch.ptr
    w1, w2 = packed_weight(params["w1"], "k_co"), packed_weight(params["w2"], "k_co")

    with _build.launcher(dev) as call:

        def normalise(gamma, beta, emb_ptr, res_ptr, res_dt, dst_ptr, dst_dt):
            call("nope_group_stats", ptr["conv"], gamma.data_ptr(), dt, ptr["mean"], ptr["scale"],
                 b, hw, c_out, groups, eps)
            call("nope_gn_silu", ptr["conv"], ptr["mean"], ptr["scale"], beta.data_ptr(), dt,
                 emb_ptr, dt, res_ptr, res_dt, dst_ptr, dst_dt, b, hw, c_out, _build.grid_y(b))

        call("nope_conv_nhwc", x.data_ptr(), w1.data_ptr(), params["b1"].data_ptr(), ptr["conv"],
             b, h, w, c_in, c_out, 3, dt, dt)
        normalise(params["g1"], params["be1"], None if emb is None else emb.data_ptr(), None, 0,
                  ptr["act"], 0)
        call("nope_conv_nhwc", ptr["act"], w2.data_ptr(), params["b2"].data_ptr(), ptr["conv"],
             b, h, w, c_out, c_out, 3, 0, dt)
        if "res_w" in params:
            # the 1x1 projection reuses `act`: the second conv, earlier on
            # the stream, has finished reading it
            res_w = packed_weight(params["res_w"], "k_co")
            call("nope_conv_nhwc", x.data_ptr(), res_w.data_ptr(), params["res_b"].data_ptr(),
                 ptr["act"], b, h, w, c_in, c_out, 1, dt, dt)
            res_ptr, res_dt = ptr["act"], 0
        else:
            res_ptr, res_dt = x.data_ptr(), dt
        normalise(params["g2"], params["be2"], None, res_ptr, res_dt, out.data_ptr(), dt)


def resnet_block(
    x: torch.Tensor, emb: Optional[torch.Tensor], params: Params, groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """K3: the whole ResnetBlock, (B, H, W, Cin) → (B, H, W, Co) in x's dtype."""
    c_in, c_out = _check(x, emb, params, groups)
    if x.device.type == "cpu":
        return resnet_block_plain(x, emb, params, groups, eps)
    _build.check_cuda("x", x)
    if c_out % 4 or c_out > 4096:
        raise ValueError(f"the CUDA kernels take Co % 4 == 0 and Co <= 4096, got {c_out}")
    for name, t in [("emb", emb), *params.items()]:
        if t is None:
            continue
        _build.check_cuda(name, t)
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} must share x's dtype and device")
    _check_aligned(x, emb, params)
    b, h, w, _ = x.shape
    out = torch.empty(b, h, w, c_out, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if x.dtype == torch.bfloat16 and _tensor_core_fits(c_in, c_out, groups):
        _block_tensor_cores(x, emb, params, groups, eps, out)
    else:
        _block_cuda_cores(x, emb, params, groups, eps, out)
    resnet_block.launches += 1
    return out


resnet_block.launches = 0
#: blocks of those that ran the bf16 tensor-core route
resnet_block.tensor_core_launches = 0


class _ResnetBlockFn(torch.autograd.Function):
    """K3 forward; backward by recomputing the plain version.  It takes
    the gradient of only the inputs that ask for one: with frozen
    parameters, no weight gradient is computed."""

    #: backward passes taken (each recomputes one plain forward)
    recomputes = 0

    @staticmethod
    def forward(ctx, groups, eps, x, emb, *ps):
        ctx.groups, ctx.eps = groups, eps
        ctx.save_for_backward(x, emb, *ps)
        return resnet_block(x, emb, {k: p for k, p in zip(_KEYS, ps) if p is not None}, groups, eps)

    @staticmethod
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        _ResnetBlockFn.recomputes += 1
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
    gradients through the plain version.  Where no gradient can flow (no
    grad mode, or no input that requires one, as when serving) it calls
    :func:`resnet_block` directly: the autograd node costs host time
    comparable to a small block's kernels."""
    ps = [params.get(k) for k in _KEYS]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, emb, *ps)):
        return _ResnetBlockFn.apply(groups, eps, x, emb, *ps)
    return resnet_block(x, emb, params, groups, eps)
