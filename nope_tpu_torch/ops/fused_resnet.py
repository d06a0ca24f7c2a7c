"""The U-Net's ResnetBlock as one op (``nope_tpu/ops/experimental/fused_resnet.py``).

    a   = SiLU(GN(conv3x3(x) + b1)) + emb
    out = SiLU(GN(conv3x3(a) + b2)) + (conv1x1(x) + res_b  or  x)

GroupNorm has ``groups`` groups, per-sample statistics and an affine.
Layout is NHWC at the boundary, as the JAX op: x (B, H, W, Cin), emb
(B, Co).  Parameters are a dict with the JAX op's keys (w1/b1/g1/be1,
w2/b2/g2/be2, optional res_w/res_b) holding the PyTorch modules'
tensors: conv weights OIHW, as ``nn.Conv2d`` stores them.

:func:`resnet_block` runs the K3 CUDA kernels (``csrc/fused_resnet.cu``)
for CUDA tensors and :func:`resnet_block_plain` for CPU tensors.  At the
widths the tensor-core tiles take (:data:`TENSOR_CORE_ROUTES`) its convs
run on the tensor cores (``wgmma``): bfloat16 directly, its activation
tiles by TMA as boxes of whole image rows or samples (:func:`tile_box`),
float32 in 3xTF32, each operand split into a tf32 hi and lo and three
products summed (:func:`conv_tf32x3_plain` is that arithmetic in plain
PyTorch);
the GroupNorm statistics come from the convs' epilogue as per-tile
partials (:func:`gn_partials_plain` and :func:`gn_merge_plain` are their
plain versions).  In bf16, where a conv's plan is fused
(:func:`conv_plan`), its epilogue also merges the partials of a sample's
tiles -- one tile, or a thread-block cluster of them over distributed
shared memory -- and applies GroupNorm and SiLU, storing bf16; other
convs keep the chain of a float32 pre-norm output, ``gn_finalize`` and
``gn_silu``.  Other widths run on the CUDA cores.  Conv weights are
laid out for the kernels once per parameter (:func:`packed_weight`).
:func:`fused_resnet_block` adds the gradient: its backward recomputes
through the plain version, as the JAX op's custom VJP does.

The 3xTF32 conv alone (:func:`conv_tf32x3`, in N tiles of
:func:`n_tile` columns) also runs the float32 SD-VAE's convs where
:func:`tf32x3_routes` says (``models/vae.py``).

:func:`group_norm_film_silu_nhwc` is GroupNorm + SiLU of a channels-last
float32 or bf16 tensor, with an embedding or a FiLM folded in: the
float32 SD-VAE's before its routed convs, and the LDM's and the ADM's bf16
res blocks (``models/ldm_unet.py``) where :func:`channels_last_norms_route`
says; ``gn_nhwc.launches`` counts its launches on the card.

Counters (``utils.profiling.counters``): ``k3.tensor_core_launches``,
``k3.tf32x3_launches`` and ``k3.cuda_core_launches``, the blocks that ran
each route (together, every K3 block launched); ``k3.fused_norms``, their
GroupNorms applied in a conv's epilogue (a fused plan; the others launched
``gn_finalize`` and ``gn_silu``); ``k3.recomputes``, the backward passes of
``_ResnetBlockFn``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from nope_tpu_torch.ops import _build
from nope_tpu_torch.utils import profiling

Params = Dict[str, torch.Tensor]
_KEYS = ("w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2", "res_w", "res_b")
#: the tensor-core conv's N tile (whole GroupNorm groups when the group
#: width divides it)
TILE_N = 192
#: the 3xTF32 conv's other N tile, for a launch that writes no GroupNorm
#: partials (see n_tile)
TILE_N_FREE = 128


class TensorCoreRoute(NamedTuple):
    """One operand type of the tensor-core conv: what it reads and how it
    tiles."""

    entry: str  # its C entry point
    layout: str  # the weight pack it reads (packed_weight)
    slice_k: int  # K-slice depth: one tap × slice_k channels, one 128-byte row
    tiles: Tuple[int, ...]  # the kernel's tile heights (output pixels), shortest first; one block an SM
    staged_below: int  # K-slices a block below which its tile is staged (0: never)
    b_rows: int  # weight rows a tile's cost counts beside its own: bf16 waits on what L2 feeds it, A and B
    boxed: bool  # A arrives by TMA in boxes of whole image rows (tiles of whole rows or samples)
    counter: str  # the counter (utils.profiling) of the blocks that ran the route


#: bf16: 64-channel slices, A by TMA, one block an SM: a ring of 5 slots
#: of 32 or 40 KB, or, where an unsplit tile takes fewer than 128 K-slices
#: and its epilogue would rival its mainloop (or its groups do not suit the
#: register epilogue: :func:`register_groups`), a staged tile (51 or 102
#: KB) that finisher warps complete -- and, fused, normalise -- during the
#: next tile, beside a ring of 5 or 3 (the kernel sizes its ring;
#: scripts/k3_tiles.py); float32
#: (3xTF32): a tf32 step reads 8 channels, so a slice is 32, and hi and lo
#: planes of A and B make a 64-row stage 64 KB (a ring of 3 fills an SM);
#: its tall tile is 128 rows, since each thread also keeps running totals.  3xTF32 is bound by its products, so
#: a tile costs its rows; bf16 by the bytes L2 feeds it, so a tile costs
#: its rows and the weight tile's 192
TENSOR_CORE_ROUTES = {
    torch.bfloat16: TensorCoreRoute("nope_conv_wgmma", "co_k", 64, (64, 128), 128, TILE_N, True,
                                    "k3.tensor_core_launches"),
    torch.float32: TensorCoreRoute("nope_conv_tf32x3", "co_k_tf32x3", 32, (64, 128), 0, 0, False,
                                   "k3.tf32x3_launches"),
}
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


def tf32_split(t: torch.Tensor):
    """float32 ``t`` as (hi, lo): hi = t rounded to tf32 (10 mantissa bits),
    to nearest with ties away from zero as ``cvt.rna.tf32.f32`` rounds;
    lo = t − hi, exact.  hi is made by integer operations on the int32
    view, so the CPU and the card give the same bits (inf and NaN stay)."""
    if t.dtype != torch.float32:
        raise TypeError(f"tf32_split takes float32, got {t.dtype}")
    bits = t.contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    hi = torch.where(special, bits, (bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, t - hi


def tf32_truncate(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` as the tensor cores read a tf32 operand: its low 13
    mantissa bits dropped."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def conv_tf32x3_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version of the 3xTF32 conv: x (B, H, W, Cin) float32,
    ``w`` (Co, Cin, k, k) with zero padding k // 2 → (B, H, W, Co) float32.
    Each operand splits as :func:`tf32_split`; lo enters truncated as the
    tensor cores read it; lo·hi + hi·lo + hi·hi + bias, summed in float64.
    The dropped lo·lo and the truncations are ~2⁻²¹ of each product."""
    xh, xl = tf32_split(x)
    wh, wl = tf32_split(w)
    xl, wl = tf32_truncate(xl), tf32_truncate(wl)

    def conv(a, b):
        return F.conv2d(a.double().permute(0, 3, 1, 2), b.double(), padding=w.shape[-1] // 2)

    out = conv(xl, wh) + conv(xh, wl) + conv(xh, wh) + bias.double()[:, None, None]
    return out.permute(0, 2, 3, 1).float()


def packed_weight(w: torch.Tensor, layout: str) -> torch.Tensor:
    """Conv weight ``w`` (Co, Cin, kh, kw) in the layout a conv kernel reads:

    - ``"co_k"``: (Co, kh·kw·Cin), K ordered (tap, ci): the bf16
      tensor-core conv's B operand, K-major as ``wgmma`` reads it
      untransposed;
    - ``"co_k_tf32x3"``: float32 (2, Co, kh·kw·Cin), the "co_k" order
      split by :func:`tf32_split` into a hi and a lo plane, the 3xTF32
      conv's B operand;
    - ``"k_co"``: (kh·kw·Cin, Co), the CUDA-core conv's operand;
    - ``"channels_last"``: (Co, Cin, kh, kw) in channels-last memory, the
      filter cuDNN's NHWC conv reads: a conv of a channels-last activation
      (``models/ldm_unet.py``) then copies no weight per call.

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
    if layout == "channels_last":
        packed = flat.view(co, kh, kw, ci).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    elif layout == "co_k":
        packed = flat.contiguous()
    elif layout == "co_k_tf32x3":
        packed = torch.stack(tf32_split(flat))
    elif layout == "k_co":
        packed = flat.t().contiguous()
    else:
        raise ValueError(f"unknown layout {layout!r}")
    packs[layout] = packed
    return packed


class ConvPlan(NamedTuple):
    bm: int  # output rows (pixels) per tile
    splits: int  # K split over this many blocks, summed in order after
    segmax: int  # most samples one tile can touch (GroupNorm partials per group)
    tile: int  # the kernel's tile height, one of the route's tiles (>= bm)
    rows: int  # boxed routes: image rows of one sample a tile holds (or all H) ...
    samples: int  # ... of this many samples; unboxed: 0, 0
    staged: int  # 1: the tile is staged and finished during the next one (boxed routes)
    cluster: int  # CTAs of a thread-block cluster along M: a fused sample's tiles, or a multicast pair
    fused: int  # 1: GroupNorm + SiLU (+ emb or res) in the conv's epilogue, bf16 out; 0: the chain
    multicast: int  # 1: the cluster's pairs of CTAs share each weight tile by TMA multicast


#: the most samples a fused tile normalises (``kFuseSegs`` in
#: csrc/fused_resnet.cu): a 128-row tile of 4x4 images touches 9
FUSE_SEGS = 9
#: the largest thread-block cluster (the portable size)
MAX_CLUSTER = 8


def tile_box(tile: int, h: int, w: int) -> Optional[Tuple[int, int]]:
    """(rows, samples) of the TMA box of a ``tile``-row tile over (h, w)
    images: whole samples when one fits, else the most whole image rows
    that fit and divide ``h``, so that tiles never straddle samples; None
    when an image row is longer than the tile."""
    if h * w <= tile:
        return h, tile // (h * w)
    if w > tile:
        return None
    return max(r for r in range(1, tile // w + 1) if h % r == 0), 1


def register_groups(c_out: int, groups: int) -> bool:
    """Whether the bf16 conv's register epilogue takes the GroupNorm
    partials of ``groups`` groups over ``c_out`` channels: each group whole
    8-column blocks, at most 8 groups in a 192-wide N tile (as
    ``register_groups`` in csrc/fused_resnet.cu).  Other groups, e.g. 32
    of 256 channels (24 in the first N tile), take the staged epilogue."""
    cg = c_out // groups
    return c_out % groups == 0 and cg % 8 == 0 and min(c_out, TILE_N) // cg <= 8


def n_tile(route: TensorCoreRoute, c_out: int, partials: bool) -> int:
    """The N tile (output columns) of a tensor-core conv of ``c_out``
    channels: :data:`TILE_N`, whose columns hold whole GroupNorm groups,
    for every launch that writes partials (every GroupNorm of a K3 block)
    and for bf16 (its kernel has that tile alone).  A float32 launch
    without partials takes :data:`TILE_N_FREE` where that leaves fewer
    columns of its last tile empty -- 128, 256 and 512 channels, the
    SD-VAE's widths, fill it, where 192 leaves 64 or 128 idle -- and
    :data:`TILE_N` on a tie (384, 768, 1536: each A tile serves more
    columns)."""
    if route.boxed or partials:
        return TILE_N
    empty = lambda tile: -(-c_out // tile) * tile - c_out  # noqa: E731
    return TILE_N_FREE if empty(TILE_N_FREE) < empty(TILE_N) else TILE_N


def conv_plan(m: int, hw: int, c_out: int, k_slices: int, sms: int, route: TensorCoreRoute,
              width: Optional[int] = None, groups: Optional[int] = None, fuse: bool = True) -> ConvPlan:
    """Tiling of the tensor-core conv of an (m, c_out) output with
    ``k_slices`` K-slices of ``route.slice_k`` channels, on a card with
    ``sms`` SMs, in N tiles of :func:`n_tile` columns (a conv given
    ``groups`` writes GroupNorm partials).  A boxed route (bf16) needs the
    image ``width``: a tile holds whole image rows or whole samples
    (:func:`tile_box`), so bm = width × rows × samples may be short of the
    kernel's tile.  The shortest tile, when its blocks do not fill the
    card, splits K until they do, each split keeping at least 4 K-slices.
    Of the route's tiles, the one that costs least in waves × rows an SM
    loads (the tile's, and ``route.b_rows`` of the weight tile; a float32
    tile of :data:`TILE_N_FREE` columns counts the hi and lo planes of its
    weight tile, since the bytes L2 feeds it set its pace, as in bf16:
    scripts/k3_tf32x3.py) per wave ÷ splits (the taller on a tie: fewer
    bytes per operation).  The tile depends on (m, hw, c_out) alone, not
    on K, so a block's convs write partials of one layout.  An unsplit boxed tile is staged when it takes fewer
    than ``route.staged_below`` K-slices, or when the conv writes
    GroupNorm partials of ``groups`` groups that :func:`register_groups`
    refuses; a split tile stores its raw sums from registers.

    A bf16 conv with ``groups`` (and ``fuse``) normalises in its epilogue
    (``fused``) where the finisher warps can, beside the next tile's
    mainloop, with no other tile's sums but its cluster's: one split, a
    staged tile, groups that :func:`register_groups` takes, and a tile of
    whole samples (touching at most :data:`FUSE_SEGS`), or a tile of whole
    rows whose sample is ``cluster`` = hw / bm <= 8 tiles, which merge
    their partials over distributed shared memory.  Other convs keep the
    chain (float32 pre-norm output, ``gn_finalize``, ``gn_silu``): a
    register epilogue runs between mainloops, where normalising cost more
    than the chain's separate pass (scripts/k3_tiles.py).  ``fuse=False``
    asks for the chain with the same tiles.  Where the tiles fill the card
    twice over, pairs of CTAs (the cluster's, or 2-CTA clusters) multicast
    the weight tile; with fewer, their lockstep costs more than it saves."""
    bn = n_tile(route, c_out, groups is not None)
    n_tiles = -(-c_out // bn)
    b_rows = 2 * bn if bn == TILE_N_FREE else route.b_rows
    best = None
    for tile in route.tiles:
        rows = samples = 0
        bm = tile
        if route.boxed:
            box = tile_box(tile, hw // width, width)
            if box is None:
                continue
            rows, samples = box
            bm = width * rows * samples
        t = -(-m // bm) * n_tiles
        fill = max(1, sms // t) if tile == route.tiles[0] else 1
        cost = -(-t * fill // sms) * (tile + b_rows) / fill
        if best is None or cost <= best[0]:
            best = (cost, tile, bm, rows, samples, min(fill, max(1, k_slices // 4)))
    if best is None:
        raise ValueError(f"no tile of {route.tiles} holds a whole image row of width {width}")
    _, tile, bm, rows, samples, splits = best
    segmax = min(bm, (bm - 2) // hw + 2)
    staged = int(route.boxed and splits == 1 and (k_slices < route.staged_below or (
        groups is not None and not register_groups(c_out, groups))))
    tiles_m = -(-m // bm)
    wide = route.boxed and tiles_m > 1 and tiles_m * n_tiles * splits >= 2 * sms
    fused = fuse and staged and groups is not None and register_groups(c_out, groups)
    whole = bm % hw == 0  # whole samples a tile
    if fused and whole and segmax <= FUSE_SEGS:
        return ConvPlan(bm, splits, segmax, tile, rows, samples, staged, 2 if wide else 1, 1, int(wide))
    cluster = hw // bm if hw % bm == 0 else 0
    if fused and not whole and 2 <= cluster <= MAX_CLUSTER:
        return ConvPlan(bm, splits, segmax, tile, rows, samples, staged, cluster, 1, int(wide and cluster % 2 == 0))
    return ConvPlan(bm, splits, segmax, tile, rows, samples, staged, 2 if wide else 1, 0, int(wide))


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
    GroupNorm scales and shifts 4 channels at a time, x by 16-byte
    ``cp.async`` or TMA boxes."""
    for name, t in (("x", x), ("emb", emb), ("g1", params.get("g1")), ("be1", params["be1"]),
                    ("g2", params.get("g2")), ("be2", params["be2"])):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned, got address {t.data_ptr():#x}")


def _tensor_core_fits(c_in: int, c_out: int, groups: int, dtype: torch.dtype, width: int = 1) -> bool:
    """Widths the tensor-core conv of ``dtype`` tiles: whole K-slices (64
    bf16 or 32 float32 channels) of x and of ``act``, the second conv's
    input, and GroupNorm groups that never straddle a 192-wide N tile; in
    bf16, image rows that fit its tallest tile (the TMA box)."""
    route = TENSOR_CORE_ROUTES.get(dtype)
    return (route is not None and c_in % route.slice_k == 0 and c_out % route.slice_k == 0
            and TILE_N % (c_out // groups) == 0 and (not route.boxed or width <= route.tiles[-1]))


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


def _conv_tensor_cores(call, route, x_ptr, w, bias, out_ptr, part_ptr, ws_ptr, shape, ks, groups,
                       plan, norm=(None, None, None, None, 0, None, 0.0)) -> None:
    """One tensor-core conv (``ks`` = 3 with zero padding, or 1): x (B, H,
    W, Cin) of the route's dtype, ``w`` = ``packed_weight(·, route.layout)``
    → out (B·H·W, Co) float32 + bias, and the tiles' GroupNorm partials
    ((ceil(M / plan.bm), G, plan.segmax, 3) float32) unless part_ptr is
    None; ws_ptr holds plan.splits·M·Co floats when K is split.  A fused
    plan (bf16) takes ``norm`` = (gamma, beta, emb, res pointers, res
    dtype code, bf16 destination pointer, eps) and writes neither out nor
    the partials."""
    b, h, wd, c_in = shape
    if route.boxed:
        tiling = (plan.tile, plan.bm, plan.rows, plan.samples, plan.staged)
        fused = (plan.cluster, plan.multicast, *norm)
    else:
        tiling, fused = (plan.bm, n_tile(route, w.shape[-2], part_ptr is not None)), ()
    call(route.entry, x_ptr, w.data_ptr(), bias.data_ptr(), _build.DTYPE_CODES[bias.dtype],
         out_ptr, part_ptr, ws_ptr, b, h, wd, c_in, w.shape[-2], ks, groups, *tiling, plan.splits, plan.segmax,
         *fused)


def _block_tensor_cores(x, emb, params, groups, eps, out):
    """Three tensor-core convs (bf16, or float32 in 3xTF32) and two
    GroupNorms, ``act`` kept in x's dtype.  A conv whose plan is fused
    normalises in its epilogue into ``act`` or ``out``; the others keep
    the chain: the float32 pre-norm output and its tiles' partials, then
    ``gn_finalize`` and ``gn_silu``.  The 1x1 residual runs before the
    second conv, whose GroupNorm adds it."""
    route = TENSOR_CORE_ROUTES[x.dtype]
    b, h, w, c_in = x.shape
    c_out, m, hw, dev = out.shape[-1], b * h * w, h * w, x.device
    sms = _build.sm_count(dev)
    plan1 = conv_plan(m, hw, c_out, 9 * c_in // route.slice_k, sms, route, w, groups)
    plan2 = conv_plan(m, hw, c_out, 9 * c_out // route.slice_k, sms, route, w, groups)
    plan_r = conv_plan(m, hw, c_out, c_in // route.slice_k, sms, route, w) if "res_w" in params else None
    splits = max(p.splits for p in (plan1, plan2, plan_r) if p is not None)
    chained = [p for p in (plan1, plan2) if not p.fused]
    mc, nb = m * c_out, b * c_out if chained else 0
    scratch = _Scratch(
        dev, conv=mc if chained else 0, res=mc if plan_r else 0, ws=splits * mc if splits > 1 else 0,
        part=-(-m // chained[0].bm) * groups * chained[0].segmax * 3 if chained else 0, mean=nb, scale=nb)
    ptr = scratch.ptr
    act = torch.empty(b, h, w, c_out, dtype=x.dtype, device=dev)
    dt = _build.DTYPE_CODES[x.dtype]

    with _build.launcher(dev) as call:

        def conv_norm(plan, src, weight, bias, gamma, beta, emb_ptr, res_ptr, res_dt, dst):
            w_packed = packed_weight(weight, route.layout)
            if plan.fused:
                _conv_tensor_cores(call, route, src.data_ptr(), w_packed, bias, None, None, ptr["ws"], src.shape, 3,
                                   groups, plan, (gamma.data_ptr(), beta.data_ptr(), emb_ptr, res_ptr, res_dt,
                                                  dst.data_ptr(), eps))
                return
            _conv_tensor_cores(call, route, src.data_ptr(), w_packed, bias, ptr["conv"], ptr["part"], ptr["ws"],
                               src.shape, 3, groups, plan)
            call("nope_gn_finalize", ptr["part"], gamma.data_ptr(), dt, ptr["mean"], ptr["scale"],
                 b, hw, c_out, groups, plan.bm, plan.segmax, eps)
            call("nope_gn_silu", ptr["conv"], ptr["mean"], ptr["scale"], beta.data_ptr(), dt,
                 emb_ptr, dt, res_ptr, res_dt, dst.data_ptr(), dt, b, hw, c_out, _build.grid_y(b))

        conv_norm(plan1, x, params["w1"], params["b1"], params["g1"], params["be1"],
                  None if emb is None else emb.data_ptr(), None, 0, act)
        if plan_r is not None:
            _conv_tensor_cores(call, route, x.data_ptr(), packed_weight(params["res_w"], route.layout),
                               params["res_b"], ptr["res"], None, ptr["ws"], x.shape, 1, groups, plan_r)
            res_ptr, res_dt = ptr["res"], 0
        else:
            res_ptr, res_dt = x.data_ptr(), dt
        conv_norm(plan2, act, params["w2"], params["b2"], params["g2"], params["be2"], None, res_ptr, res_dt, out)
    profiling.count(route.counter)
    profiling.count("k3.fused_norms", 2 - len(chained))


def resident_clusters(device: torch.device, tile: int, staged: bool, cluster: int) -> int:
    """How many clusters of ``cluster`` CTAs of the bf16 conv kernel
    (``tile`` rows, staged epilogue or not) ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters``): its persistent grid."""
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = _build.library().nope_conv_clusters(tile, int(staged), cluster, ctypes.byref(count))
    if status:
        raise RuntimeError(f"nope_conv_clusters: CUDA error {status}")
    return count.value


def _block_cuda_cores(x, emb, params, groups, eps, out):
    """Widths neither tensor-core route takes, in either dtype (and, called
    directly, the exact float32 yardstick of the 3xTF32 route): the
    CUDA-core conv, two-pass statistics, float32 ``act``."""
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
    if _tensor_core_fits(c_in, c_out, groups, x.dtype, w):
        _block_tensor_cores(x, emb, params, groups, eps, out)
    else:
        _block_cuda_cores(x, emb, params, groups, eps, out)
        profiling.count("k3.cuda_core_launches")
    return out


def conv_tf32x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 conv of K3's float32 route alone, without GroupNorm:
    x (B, H, W, Cin) float32, ``w`` (Co, Cin, k, k) for k in {1, 3} →
    (B, H, W, Co) float32.  A CUDA tensor runs the kernel (Cin % 32 == 0,
    Co % 8 == 0), in N tiles of :func:`n_tile` columns (it writes no
    partials); a CPU tensor :func:`conv_tf32x3_plain`.  The float32
    SD-VAE's convs take it where :func:`tf32x3_routes` says."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[1] != x.shape[-1] or w.shape[-1] not in (1, 3):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are not a K3 conv")
    if x.device.type == "cpu":
        return conv_tf32x3_plain(x, w, bias)
    route = TENSOR_CORE_ROUTES[torch.float32]
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        _build.check_cuda(name, t, (torch.float32,))
    b, h, wd, c_in = x.shape
    c_out, m = w.shape[0], b * h * wd
    if c_in % route.slice_k or c_out % 8 or x.data_ptr() % 16:
        raise ValueError(f"the 3xTF32 conv takes Cin % 32 == 0, Co % 8 == 0, 16-byte aligned x; got "
                         f"Cin={c_in}, Co={c_out}")
    out = torch.empty(b, h, wd, c_out, dtype=torch.float32, device=x.device)
    plan = conv_plan(m, h * wd, c_out, w.shape[-1] ** 2 * c_in // route.slice_k, _build.sm_count(x.device),
                     route)
    ws = torch.empty(plan.splits * m * c_out if plan.splits > 1 else 0, dtype=torch.float32, device=x.device)
    with _build.launcher(x.device) as call:
        _conv_tensor_cores(call, route, x.data_ptr(), packed_weight(w, route.layout), bias, out.data_ptr(),
                           None, ws.data_ptr() if ws.numel() else None, x.shape, w.shape[-1], 1, plan)
    return out


def tf32x3_routes(dtype: torch.dtype, device_type: str, grad: bool, stride: Tuple[int, int],
                  padding: Tuple[int, int], kernel: Tuple[int, int], c_in: int, c_out: int) -> bool:
    """Whether a conv (an ``nn.Conv2d``'s ``stride``, ``padding`` and
    ``kernel_size``) runs on :func:`conv_tf32x3` in place of ``F.conv2d``:
    float32 on the card with no gradient asked (the kernel has no
    backward); stride 1, a 1x1 or 3x3 kernel with zero padding k // 2;
    whole 32-channel K-slices (Cin % 32 == 0); and whole
    :data:`TILE_N_FREE` N tiles (Co % 128 == 0), since a narrower output
    -- the SD-VAE encoder's 8-channel ``conv_out`` -- would leave most
    of its tile's columns idle.  bf16 keeps cuDNN's tensor-core convs."""
    k = kernel[0]
    return (dtype == torch.float32 and device_type == "cuda" and not grad and tuple(stride) == (1, 1)
            and tuple(kernel) == (k, k) and k in (1, 3) and tuple(padding) == (k // 2, k // 2)
            and c_in % TENSOR_CORE_ROUTES[torch.float32].slice_k == 0 and c_out % TILE_N_FREE == 0)


#: threads of a block of the channels-last GroupNorm pair: C / V across a
#: pixel (16 bytes each: V = 8 bf16 or 4 float32 channels), 256 / (C / V)
#: pixels deep
NORM_THREADS = 256
#: pixels a thread of the pair holds per step (the kernels' kNormRows)
NORM_ROWS = 8
#: blocks an SM the pair's plan aims at before it splits samples
NORM_BLOCKS_PER_SM = 16


def norm_vec(dtype: torch.dtype) -> int:
    """V, the channels of one 16-byte vector of the pair: 8 bf16 or 4 float32."""
    return 16 // dtype.itemsize


def nhwc_norm_fits(dtype: torch.dtype, c: int, groups: int) -> bool:
    """Whether the channels-last GroupNorm pair takes a GroupNorm of ``c``
    channels in ``groups`` groups of x in ``dtype``: whole 16-byte vectors a
    group (C % (V·groups) == 0, V = :func:`norm_vec`) that one block spans
    (C ≤ V·:data:`NORM_THREADS`), with at most 32 groups."""
    v = norm_vec(dtype)
    return 1 <= groups <= 32 and c % (v * groups) == 0 and c <= v * NORM_THREADS


def channels_last_norms_route(dtype: torch.dtype, device_type: str, grad: bool, channels_last: bool,
                              widths: Tuple[int, ...], groups: int) -> bool:
    """Whether a res block's GroupNorms run on :func:`group_norm_film_silu_nhwc`'s
    kernel pair: bf16 on the card outside grad mode (the pair has no
    backward; the float32 blocks of the loss keep the plain ops), the
    block's input channels-last, and each GroupNorm's width in ``widths``
    one the pair takes (:func:`nhwc_norm_fits`)."""
    return (dtype == torch.bfloat16 and device_type == "cuda" and not grad and channels_last
            and all(nhwc_norm_fits(dtype, c, groups) for c in widths))


def norm_plan(batch: int, hw: int, c: int, sms: int, vec: int) -> Tuple[int, int]:
    """(span, splits) of the channels-last GroupNorm pair at ``vec``
    channels a thread (:func:`norm_vec`): each block takes ``span`` pixels
    of one sample, ``splits`` blocks a sample.  A span is whole steps of
    ny·:data:`NORM_ROWS` pixels; a sample splits only as far as it takes the
    batch to make :data:`NORM_BLOCKS_PER_SM` blocks an SM."""
    ny = max(1, NORM_THREADS // (c // vec))
    step = ny * NORM_ROWS
    steps = -(-hw // step)
    per = -(-steps // min(steps, -(-NORM_BLOCKS_PER_SM * sms // batch)))
    return per * step, -(-steps // per)


def norm_tables(mean: torch.Tensor, rstd: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                addend: Optional[torch.Tensor] = None, film: Optional[torch.Tensor] = None):
    """GroupNorm's statistics (B, G) of ``x + addend``, its affine and the
    FiLM folded into float32 (B, C) tables m, a and d, so that
    ``SiLU((x − m)·a + d)`` is :func:`group_norm_film_silu_nhwc`:
    m = mean − addend, a = rstd·γ·(1 + scale), d = β·(1 + scale) + shift.
    x is centred before the scale, so a group whose mean is far above its
    spread loses no more than ``nn.GroupNorm`` does."""
    cg = gamma.numel() // mean.shape[1]
    m = mean.repeat_interleave(cg, dim=1)
    if addend is not None:
        m = m - addend.float()
    a = rstd.repeat_interleave(cg, dim=1) * gamma.float()
    d = beta.float().expand_as(a)
    if film is not None:
        scale, shift = film.float().chunk(2, dim=1)
        a, d = a * (1 + scale), d * (1 + scale) + shift
    return m, a, d


def group_norm_film_silu_nhwc(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float,
                              addend: Optional[torch.Tensor] = None,
                              film: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SiLU(GroupNorm(x + addend)·(1 + scale) + shift) of an NHWC x (B, H, W,
    C), kept NHWC (``nn.GroupNorm`` hands a channels-last tensor back
    NCHW-contiguous), in x's dtype: float32 statistics per (sample, group);
    ``addend`` (B, C) is added before them (the LDM's embedding), ``film``
    (B, 2C) = [scale | shift] applies after (the ADM's), either or neither.
    Folded into (B, C) tables (:func:`norm_tables`), out = SiLU((x − m)·a + d).
    A CUDA tensor runs the kernel pair ``gn_nhwc_stats`` / ``gn_nhwc_apply``
    (float32 or bf16, the widths :func:`nhwc_norm_fits` takes), counting
    ``gn_nhwc.launches``; a CPU tensor the same arithmetic in plain
    PyTorch."""
    b, h, w, c = x.shape
    if x.device.type == "cpu":
        v = x.float() if addend is None else x.float() + addend.float()[:, None, None]
        var, mean = torch.var_mean(v.reshape(b, h * w, groups, c // groups), dim=(1, 3), unbiased=False)
        m, a, d = (t[:, None, None] for t in norm_tables(mean, torch.rsqrt(var + eps), gamma, beta, addend, film))
        return F.silu((x.float() - m) * a + d).to(x.dtype)
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta), ("addend", addend), ("film", film)):
        if t is not None:
            _build.check_cuda(name, t)
    if not nhwc_norm_fits(x.dtype, c, groups) or gamma.dtype != beta.dtype or x.data_ptr() % 16:
        v = norm_vec(x.dtype)
        raise ValueError(f"the channels-last GroupNorm of {x.dtype} takes C % ({v}·groups) == 0, "
                         f"C <= {v * NORM_THREADS}, groups <= 32, 16-byte aligned x and gamma, beta of one dtype; "
                         f"got C={c}, groups={groups}")
    if (addend is not None and addend.shape != (b, c)) or (film is not None and film.shape != (b, 2 * c)):
        raise ValueError(f"addend must be (B, C) and film (B, 2C) for x {tuple(x.shape)}")
    out = torch.empty_like(x)
    if out.numel():
        profiling.count("gn_nhwc.launches")
        _norm_kernels(x, gamma, beta, groups, eps, addend, film, out)
    return out


def _norm_kernels(x, gamma, beta, groups, eps, addend, film, out) -> None:
    """The pair's launches: the statistics into a (B, splits, G, 3) float32
    scratch of partials, then the apply into ``out``."""
    b, h, w, c = x.shape
    span, splits = norm_plan(b, h * w, c, _build.sm_count(x.device), norm_vec(x.dtype))
    part = torch.empty(b * splits * groups * 3, dtype=torch.float32, device=x.device)
    codes = _build.DTYPE_CODES
    add = (None, 0) if addend is None else (addend.data_ptr(), codes[addend.dtype])
    mod = (None, 0) if film is None else (film.data_ptr(), codes[film.dtype])
    shape = (b, h * w, c, groups, span, splits, _build.grid_y(b))
    with _build.launcher(x.device) as call:
        call("nope_gn_nhwc_stats", x.data_ptr(), codes[x.dtype], *add, part.data_ptr(), *shape)
        call("nope_gn_nhwc_apply", x.data_ptr(), codes[x.dtype], part.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             codes[gamma.dtype], *add, *mod, out.data_ptr(), *shape, eps)


class _ResnetBlockFn(torch.autograd.Function):
    """K3 forward; backward by recomputing the plain version.  It takes
    the gradient of only the inputs that ask for one: with frozen
    parameters, no weight gradient is computed."""

    @staticmethod
    def forward(ctx, groups, eps, x, emb, *ps):
        ctx.groups, ctx.eps = groups, eps
        ctx.save_for_backward(x, emb, *ps)
        return resnet_block(x, emb, {k: p for k, p in zip(_KEYS, ps) if p is not None}, groups, eps)

    @staticmethod
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        profiling.count("k3.recomputes")  # each recomputes one plain forward
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
