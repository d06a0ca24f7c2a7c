"""K3's tensor-core routes, in plain torch on the CPU: the packed weight
layout the conv reads, the per-tile GroupNorm partials and their Chan
merge against the JAX package's GroupNorm, the tiling plan, and the
wrapper's launches (pointers, offsets, split-K, statistics) of the bf16
route, the float32 3xTF32 route and the CUDA-core route run against an
emulation of the C entry points on host memory."""

import contextlib
import ctypes
import gc

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from nope_tpu.ops.experimental.fused_resnet import _group_norm
from nope_tpu_torch.ops import _build
from nope_tpu_torch.ops import fused_resnet as fr
from nope_tpu_torch.utils import profiling

torch.set_num_threads(1)


def im2col(x: torch.Tensor, ks: int) -> torch.Tensor:
    """(B, H, W, Cin) → (B·H·W, ks·ks·Cin), K ordered (tap, ci), zero halo."""
    b, h, w, c = x.shape
    p = ks // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    cols = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(ks) for dx in range(ks)]
    return torch.cat(cols, dim=-1).reshape(b * h * w, ks * ks * c)


def box_cols(x: torch.Tensor, ks: int, bm: int, rows: int, samples: int) -> torch.Tensor:
    """(B·H·W, ks·ks·Cin), K ordered (tap, ci): the A rows of every
    ``bm``-pixel tile as the bf16 conv's TMA loads deliver them.  Tile mt
    starts at pixel m0 = mt·bm, sample b0 = m0 // HW, row y0 = (m0 mod HW)
    // W; tap (dy, dx) is the box of (W, rows, samples) pixels at (dx − p,
    y0 + dy − p, b0), zero where it leaves x; a ragged last tile keeps its
    first M − m0 rows."""
    b, h, w, c = x.shape
    p, hw, m = ks // 2, h * w, b * h * w
    xp = F.pad(x, (0, 0, p, p, p, p))
    xp = torch.cat([xp, xp.new_zeros(samples, *xp.shape[1:])])  # samples past B read as zeros
    out = x.new_empty(m, ks * ks * c)
    for mt in range(-(-m // bm)):
        m0 = mt * bm
        b0, y0, n = m0 // hw, (m0 % hw) // w, min(bm, m - m0)
        taps = []
        for tap in range(ks * ks):
            dy, dx = tap // ks - p, tap % ks - p
            box = xp[b0:b0 + samples, y0 + dy + p:y0 + dy + p + rows, dx + p:dx + p + w]
            assert box.shape == (samples, rows, w, c)
            taps.append(box.reshape(-1, c)[:n])
        out[m0:m0 + n] = torch.cat(taps, 1)
    return out


# (B, H, W, ks, tile): whole rows of one sample (32x32 in 2 or 4 rows, 16x16
# in 4 or 8), whole samples (8x8 in 1 or 2, 4x4 in 4 or 8) with a last tile
# past B, rows that do not fill the tile (28x28: 2 rows of 28 in 64, 4 in
# 128), a non-square image, samples that do not fill it (6x6: 3 of 36 in 128)
BOXES = [(2, 32, 32, 3, 128), (2, 32, 32, 3, 64), (3, 16, 16, 3, 128), (3, 16, 16, 1, 64), (3, 8, 8, 3, 128),
         (5, 4, 4, 3, 64), (13, 4, 4, 3, 128), (19, 4, 4, 1, 128), (2, 28, 28, 3, 128), (2, 28, 28, 1, 64),
         (3, 6, 10, 3, 64), (7, 6, 6, 3, 128)]


@pytest.mark.parametrize("b,h,w,ks,tile", BOXES)
def test_tma_boxes_are_the_padded_im2col(b, h, w, ks, tile):
    """The shifted boxes with zero fill reproduce im2col of the padded input,
    tile by tile, at the box that ``tile_box`` gives the kernel."""
    rows, samples = fr.tile_box(tile, h, w)
    bm = w * rows * samples
    assert bm <= tile and h % rows == 0 and (samples == 1 or rows == h)
    x = torch.randn(b, h, w, 8, generator=torch.Generator().manual_seed(b * h + w))
    torch.testing.assert_close(box_cols(x, ks, bm, rows, samples), im2col(x, ks), rtol=0, atol=0)


def test_tile_box():
    assert fr.tile_box(128, 32, 32) == (4, 1) and fr.tile_box(64, 32, 32) == (2, 1)
    assert fr.tile_box(128, 16, 16) == (8, 1) and fr.tile_box(64, 8, 8) == (8, 1)
    assert fr.tile_box(128, 8, 8) == (8, 2) and fr.tile_box(128, 4, 4) == (4, 8)
    assert fr.tile_box(128, 28, 28) == (4, 1) and fr.tile_box(64, 5, 40) == (1, 1)
    assert fr.tile_box(128, 2, 300) is None  # a row longer than the tile: no box


@pytest.mark.parametrize("ks", [3, 1])
def test_packed_layout_is_the_gemm_operand(ks):
    rng = np.random.default_rng(ks)
    cin, co = 16, 24
    x = rng.normal(size=(2, 5, 6, cin)).astype(np.float32)
    w_hwio = (rng.normal(size=(ks, ks, cin, co)) * 0.2).astype(np.float32)
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))  # OIHW
    pack = fr.packed_weight(w, "co_k")
    assert pack.shape == (co, ks * ks * cin) and pack.is_contiguous()
    # the pack is the HWIO weight read as (K, Co), transposed: K = (tap, ci)
    np.testing.assert_array_equal(pack.numpy(), w_hwio.reshape(ks * ks * cin, co).T)
    np.testing.assert_array_equal(fr.packed_weight(w, "k_co").numpy(), w_hwio.reshape(-1, co))
    got = (im2col(torch.from_numpy(x), ks) @ pack.t()).reshape(2, 5, 6, co)
    torch_conv = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, padding=ks // 2).permute(0, 2, 3, 1)
    with jax.default_matmul_precision("highest"):
        jax_conv = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w_hwio), (1, 1), ((ks // 2,) * 2,) * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(got.numpy(), torch_conv.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_conv), atol=1e-5, rtol=1e-5)


def test_pack_is_made_once_and_follows_in_place_updates():
    conv = torch.nn.Conv2d(8, 16, 3)
    first = fr.packed_weight(conv.weight, "co_k")
    assert fr.packed_weight(conv.weight, "co_k") is first  # no copy per forward
    with torch.no_grad():
        conv.weight.mul_(2.0)  # an optimizer step or copy_ bumps _version
    second = fr.packed_weight(conv.weight, "co_k")
    assert second is not first
    np.testing.assert_array_equal(second.numpy(), 2.0 * first.numpy())
    conv.load_state_dict({"weight": torch.zeros_like(conv.weight), "bias": conv.bias.detach()})
    assert not fr.packed_weight(conv.weight, "co_k").any()
    with pytest.raises(ValueError, match="layout"):
        fr.packed_weight(conv.weight, "hwio")


def test_packs_drop_with_a_dtype_change_and_with_the_parameter():
    """``Module.to`` swaps a parameter's data in place: its packs of the
    old dtype go, and so do all its packs when the parameter goes."""
    conv = torch.nn.Conv2d(8, 16, 3)
    fr.packed_weight(conv.weight, "co_k")
    fr.packed_weight(conv.weight, "k_co")
    assert set(fr._PACKS[conv.weight][1]) == {"co_k", "k_co"}
    conv.to(torch.bfloat16)
    assert fr.packed_weight(conv.weight, "co_k").dtype == torch.bfloat16
    assert set(fr._PACKS[conv.weight][1]) == {"co_k"}
    assert "_k3_packs" not in conv.weight.__dict__  # nothing is pickled with the module
    n = len(fr._PACKS)
    del conv
    gc.collect()
    assert len(fr._PACKS) == n - 1


def test_misaligned_inputs_are_refused():
    """The kernels read x, emb and the GroupNorm shifts 16 bytes at a
    time: a contiguous view at an odd offset raises instead of faulting."""
    b, hw, c = 2, 4, 8
    x = torch.zeros(b * hw * hw * c + 1)
    params = {"be1": torch.zeros(c), "be2": torch.zeros(c)}
    aligned = x[:-1].reshape(b, hw, hw, c)
    fr._check_aligned(aligned, torch.zeros(b, c), params)
    with pytest.raises(ValueError, match="x must be 16-byte aligned"):
        fr._check_aligned(x[1:].reshape(b, hw, hw, c), None, params)
    with pytest.raises(ValueError, match="emb must be 16-byte aligned"):
        fr._check_aligned(aligned, torch.zeros(b * c + 1)[1:].reshape(b, c), params)
    with pytest.raises(ValueError, match="be2 must be 16-byte aligned"):
        fr._check_aligned(aligned, None, {**params, "be2": torch.zeros(c + 1)[1:]})


def test_autograd_function_hands_the_parameters_through():
    """The pack is cached per parameter object, so the op must see the
    caller's parameters and not copies of them."""
    seen = []
    real = fr.resnet_block

    def spy(x, emb, params, groups, eps):
        seen.append({k: id(v) for k, v in params.items()})
        return real(x, emb, params, groups, eps)

    conv = torch.nn.Conv2d(8, 8, 3, padding=1)
    params = {"w1": conv.weight, "b1": conv.bias, "g1": torch.ones(8), "be1": torch.zeros(8),
              "w2": conv.weight, "b2": conv.bias, "g2": torch.ones(8), "be2": torch.zeros(8)}
    fr.resnet_block = spy
    try:
        fr.fused_resnet_block(torch.zeros(1, 4, 4, 8), None, params)
    finally:
        fr.resnet_block = real
    assert seen == [{k: id(v) for k, v in params.items()}]


def test_no_grad_forward_skips_the_autograd_node(monkeypatch):
    """Serving runs under no_grad: the op calls the block directly, with
    the result of the autograd path."""
    conv = torch.nn.Conv2d(8, 8, 3, padding=1)
    params = {"w1": conv.weight, "b1": conv.bias, "g1": torch.ones(8), "be1": torch.zeros(8),
              "w2": conv.weight, "b2": conv.bias, "g2": torch.ones(8), "be2": torch.zeros(8)}
    x = torch.randn(2, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    with_grad = fr.fused_resnet_block(x, None, params)
    assert with_grad.requires_grad

    def refuse(*args):
        raise AssertionError("the autograd node ran under no_grad")

    monkeypatch.setattr(fr._ResnetBlockFn, "apply", refuse)
    with torch.no_grad():
        served = fr.fused_resnet_block(x, None, params)
    torch.testing.assert_close(served, with_grad.detach(), rtol=0, atol=0)


# (H·W, Co, batch, bm): HW=16 with 128-row tiles spanning 8 samples; cg=24
# at Co=192; tiles that cut samples (HW=48; 192-row tiles at HW=1024);
# samples over many tiles.  The merge takes any partition; the kernel's
# tiles are the routes' (fr.TENSOR_CORE_ROUTES)
PARTITIONS = [(16, 768, 26, 128), (16, 192, 3, 64), (1024, 192, 2, 128), (48, 192, 5, 128),
              (64, 384, 3, 128), (256, 192, 3, 64), (1024, 384, 3, 192), (16, 1536, 13, 192)]


@pytest.mark.parametrize("hw,co,batch,bm", PARTITIONS)
def test_partials_merge_to_the_jax_group_norm(hw, co, batch, bm):
    groups, eps = 8, 1e-5
    rng = np.random.default_rng(hw + co)
    h = (rng.normal(size=(batch * hw, co)) * 2.0 + 0.5).astype(np.float32)
    part = fr.gn_partials_plain(torch.from_numpy(h), hw, groups, bm)
    assert part.shape == (-(-batch * hw // bm), groups, min(bm, (bm - 2) // hw + 2), 3)
    mean, rstd = fr.gn_merge_plain(part, batch, hw, bm, eps)
    cg = co // groups
    got = (torch.from_numpy(h).reshape(batch, hw, groups, cg) - mean.reshape(batch, 1, groups, 1))
    got = (got * rstd.reshape(batch, 1, groups, 1)).reshape(batch, hw, co)
    side = int(np.sqrt(hw)) if int(np.sqrt(hw)) ** 2 == hw else 1
    want = _group_norm(jnp.asarray(h.reshape(batch, side, hw // side, co)), jnp.ones(co), jnp.zeros(co),
                       groups, eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(batch, hw, co), atol=1e-4, rtol=1e-4)
    hg = h.astype(np.float64).reshape(batch, hw, groups, cg)
    np.testing.assert_allclose(mean.numpy().reshape(batch, groups), hg.mean((1, 3)), rtol=1e-5, atol=1e-6)


def test_merge_keeps_the_digits_that_e_x2_loses():
    """|mean| ≫ std: float32 E[x²] − mean² cancels; the two-pass tile
    partials merged with Chan's formula do not."""
    batch, hw, co, groups, bm = 3, 64, 192, 8, 128
    rng = np.random.default_rng(5)
    h = (1000.0 + 0.01 * rng.normal(size=(batch * hw, co))).astype(np.float32)
    want = h.astype(np.float64).reshape(batch, hw, groups, -1).var((1, 3))
    mean, rstd = fr.gn_merge_plain(fr.gn_partials_plain(torch.from_numpy(h), hw, groups, bm), batch, hw, bm, 0.0)
    var = (1.0 / rstd.double() ** 2).numpy().reshape(batch, groups)
    np.testing.assert_allclose(var, want, rtol=1e-2)
    hg = torch.from_numpy(h).reshape(batch, hw, groups, -1)
    naive = (hg * hg).mean((1, 3)) - hg.mean((1, 3)) ** 2
    assert np.abs(naive.double().numpy() - want).max() > 10 * want.max()


# (m, hw, W, co, k_slices) → (bm, splits, segmax, tile, rows, samples, staged, cluster, fused, multicast);
# split tiles leave their raw sums from registers; no groups: no fused epilogue; tiles that fill the card
# twice over run in 2-CTA pairs that multicast the weight tile
@pytest.mark.parametrize("m,hw,width,co,k_slices,want", [
    (26 * 1024, 1024, 32, 192, 27, (128, 1, 2, 128, 4, 1, 1, 1, 0, 0)),    # 32x32 at B=26: 4 whole rows, staged
    (3328 * 1024, 1024, 32, 192, 27, (128, 1, 2, 128, 4, 1, 1, 2, 0, 1)),  # the eval call: as many waves as 64 rows
    (3 * 1024, 1024, 32, 192, 27, (64, 2, 2, 64, 2, 1, 0, 1, 0, 0)),       # 32x32 at B=3: 2 rows, K split in 2
    (26 * 256, 256, 16, 192, 27, (64, 1, 2, 64, 4, 1, 1, 1, 0, 0)),        # 16x16 at B=26: 104 tiles fill the card
    (26 * 256, 256, 16, 384, 81, (128, 1, 2, 128, 8, 1, 1, 1, 0, 0)),      # 16x16, Co=384: 8 whole rows
    (26 * 64, 64, 8, 768, 162, (64, 1, 2, 64, 8, 1, 0, 1, 0, 0)),          # 8x8 at B=26: one sample; 162 slices
    (3328 * 64, 64, 8, 768, 162, (128, 1, 3, 128, 8, 2, 0, 2, 0, 1)),      # 8x8 at 3,328: two samples a tile
    (3 * 16, 16, 4, 1536, 216, (64, 16, 5, 64, 4, 4, 0, 1, 0, 0)),         # 4x4 at B=3: the tile past B; 16 splits
    (26 * 16, 16, 4, 1536, 216, (64, 2, 5, 64, 4, 4, 0, 1, 0, 0)),         # 4x4 at B=26: 56 tiles, K split in 2
    (341 * 16, 16, 4, 768, 108, (128, 1, 9, 128, 4, 8, 1, 1, 0, 0)),       # 4x4 at B=341: 8 samples, the last past B
    (3 * 16, 16, 4, 768, 6, (64, 1, 5, 64, 4, 4, 1, 1, 0, 0)),             # too few K-slices to split
    (2 * 784, 784, 28, 192, 27, (56, 4, 2, 64, 2, 1, 0, 1, 0, 0)),         # 28x28: 2 rows of 28 fill 56 of 64 rows
])
def test_conv_plan(m, hw, width, co, k_slices, want):
    assert tuple(fr.conv_plan(m, hw, co, k_slices, 132, fr.TENSOR_CORE_ROUTES[torch.bfloat16], width)) == want


# (B, (H, W, Cin, Co) of a flagship block) → (cluster, fused, multicast) of its two convs, with the
# flagship's 8 groups on 132 SMs: a 32x32 sample is 8 staged tiles of 4 rows, a 16x16 one 2 of 8 rows (4 of
# 4 at B=26), which merge their partials in a cluster; 8x8 and 4x4 tiles hold whole samples; split K (all
# of B=3, the 8x8 384 and 4x4 stages at B=26) and a register epilogue (128+ K-slices: 4x4 1536 and 2304,
# the 8x8 1152's first conv) keep the chain; pairs of CTAs multicast the weight tile where the tiles fill
# the card twice over
FLAGSHIP_BLOCKS = {"32x32 192": (32, 32, 192, 192), "32x32 384": (32, 32, 384, 192), "16x16 192": (16, 16, 192, 192),
                   "16x16 576": (16, 16, 576, 384), "8x8 384": (8, 8, 384, 384), "8x8 1152": (8, 8, 1152, 768),
                   "4x4 768": (4, 4, 768, 768), "4x4 1536": (4, 4, 1536, 1536), "4x4 2304": (4, 4, 2304, 1536)}
CHAIN, PAIR_CHAIN = (1, 0, 0), (2, 0, 1)
CLUSTERS = {
    3: {k: (CHAIN, CHAIN) for k in FLAGSHIP_BLOCKS},
    26: {"32x32 192": ((8, 1, 0),) * 2, "32x32 384": ((8, 1, 0),) * 2, "16x16 192": ((4, 1, 0),) * 2,
         "16x16 576": ((2, 1, 0),) * 2, "8x8 384": (CHAIN, CHAIN), "8x8 1152": (CHAIN, (1, 1, 0)),
         "4x4 768": (CHAIN, CHAIN), "4x4 1536": (CHAIN, CHAIN), "4x4 2304": (CHAIN, CHAIN)},
    341: {"32x32 192": ((8, 1, 1),) * 2, "32x32 384": ((8, 1, 1),) * 2, "16x16 192": ((2, 1, 1),) * 2,
          "16x16 576": ((2, 1, 1),) * 2, "8x8 384": ((2, 1, 1),) * 2, "8x8 1152": (PAIR_CHAIN, (2, 1, 1)),
          "4x4 768": ((1, 1, 0),) * 2, "4x4 1536": (PAIR_CHAIN,) * 2, "4x4 2304": (PAIR_CHAIN,) * 2},
    3328: {"32x32 192": ((8, 1, 1),) * 2, "32x32 384": ((8, 1, 1),) * 2, "16x16 192": ((2, 1, 1),) * 2,
           "16x16 576": ((2, 1, 1),) * 2, "8x8 384": ((2, 1, 1),) * 2, "8x8 1152": (PAIR_CHAIN, (2, 1, 1)),
           "4x4 768": ((2, 1, 1),) * 2, "4x4 1536": (PAIR_CHAIN,) * 2, "4x4 2304": (PAIR_CHAIN,) * 2},
}


@pytest.mark.parametrize("batch,block", [(b, k) for b in CLUSTERS for k in FLAGSHIP_BLOCKS])
def test_conv_plan_clusters_of_the_flagship_blocks(batch, block):
    h, w, cin, co = FLAGSHIP_BLOCKS[block]
    r = fr.TENSOR_CORE_ROUTES[torch.bfloat16]
    for k_slices, want in zip((9 * cin // 64, 9 * co // 64), CLUSTERS[batch][block]):
        plan = fr.conv_plan(batch * h * w, h * w, co, k_slices, 132, r, w, 8)
        assert (plan.cluster, plan.fused, plan.multicast) == want, plan
        assert plan.staged or not plan.fused
        if plan.fused and plan.bm < h * w:  # a cluster of tiles that make one sample
            assert plan.cluster * plan.bm == h * w
        chain = fr.conv_plan(batch * h * w, h * w, co, k_slices, 132, r, w, 8, fuse=False)
        assert chain._replace(cluster=0, fused=0, multicast=0) == plan._replace(cluster=0, fused=0, multicast=0)
        assert not chain.fused and chain.cluster <= 2


# (m, hw, W, co, k_slices, groups): convs that keep the chain although they write GroupNorm partials
@pytest.mark.parametrize("m,hw,width,co,k_slices,groups", [
    (26 * 16, 16, 4, 1536, 216, 8),    # K split in 2
    (3 * 1024, 1024, 32, 192, 27, 8),  # K split in 2
    (341 * 64, 64, 8, 256, 108, 32),   # cg = 8: 24 groups in the first N tile
    (341 * 16, 16, 4, 768, 108, 64),   # cg = 12: groups straddle 8-column blocks
    (3 * 16, 4, 2, 192, 6, 8),         # 2x2 images: a staged tile touches 33 samples (FUSE_SEGS = 9)
    (26 * 1024, 1024, 32, 192, 216, 8),  # a register epilogue (216 K-slices) runs between mainloops
    (2 * 4096, 4096, 64, 192, 27, 8),  # a 64x64 sample is 32 tiles: more than a cluster holds
])
def test_conv_plan_keeps_the_chain(m, hw, width, co, k_slices, groups):
    r = fr.TENSOR_CORE_ROUTES[torch.bfloat16]
    plan = fr.conv_plan(m, hw, co, k_slices, 132, r, width, groups)
    assert not plan.fused and plan.cluster == 1 + plan.multicast  # at most a multicast pair
    assert plan == fr.conv_plan(m, hw, co, k_slices, 132, r, width, groups, fuse=False)
    assert not fr.conv_plan(m, hw, co, k_slices, 132, fr.TENSOR_CORE_ROUTES[torch.float32], width, groups).fused


# (m, hw, W, co, k_slices, groups) → staged: at 216 K-slices, the register epilogue takes
# groups of whole 8-column blocks, at most 8 of them in the N tile
@pytest.mark.parametrize("m,hw,width,co,k_slices,groups,staged", [
    (341 * 16, 16, 4, 768, 216, 8, 0),     # the flagship's 8 groups: cg = 96, 2 in an N tile
    (341 * 16, 16, 4, 768, 216, 32, 0),    # cg = 24: 8 in an N tile
    (341 * 16, 16, 4, 768, 216, 64, 1),    # cg = 12: groups straddle 8-column blocks
    (341 * 64, 64, 8, 256, 216, 32, 1),    # cg = 8: 24 groups in the first N tile
    (341 * 64, 64, 8, 256, 216, 8, 0),     # cg = 32: 6 groups, then 2 in the last 64 columns
    (341 * 64, 64, 8, 128, 216, 8, 0),     # cg = 16: 8 groups in the one 128-column tile
    (341 * 64, 64, 8, 256, 216, None, 0),  # no partials (the 1x1 residual): any groups
])
def test_conv_plan_stages_the_groups_the_registers_cannot_take(m, hw, width, co, k_slices, groups, staged):
    r = fr.TENSOR_CORE_ROUTES[torch.bfloat16]
    plan = fr.conv_plan(m, hw, co, k_slices, 132, r, width, groups)
    assert plan.splits == 1 and plan.staged == staged
    without = fr.conv_plan(m, hw, co, k_slices, 132, r, width)
    assert plan._replace(staged=0, fused=0) == without._replace(staged=0)  # the same tile either way


def test_conv_plan_takes_the_tile_and_not_k():
    """A block's two convs (and its 1x1 residual) share one partial layout:
    the tile depends on the output, not on K."""
    r = fr.TENSOR_CORE_ROUTES[torch.bfloat16]
    for m, hw, width, co in ((3 * 16, 16, 4, 1536), (26 * 256, 256, 16, 384), (341 * 1024, 1024, 32, 192)):
        plans = [fr.conv_plan(m, hw, co, k, 132, r, width) for k in (2, 6, 27, 216)]
        assert len({(p.bm, p.segmax, p.tile, p.rows, p.samples) for p in plans}) == 1, plans


def test_wide_rows_leave_the_bf16_tensor_cores():
    """A row wider than the tallest bf16 tile has no TMA box: the block runs
    on the CUDA cores in bf16; float32 gathers A and keeps its route."""
    assert fr._tensor_core_fits(192, 192, 8, torch.bfloat16, 128)
    assert not fr._tensor_core_fits(192, 192, 8, torch.bfloat16, 129)
    assert fr._tensor_core_fits(192, 192, 8, torch.float32, 129)


# -- the wrapper's launches against an emulation of the C entry points --------

def _view(ptr, n, dt):
    """n elements of dtype code dt at host address ptr, as a torch view."""
    if dt == 0:
        return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr)))
    raw = np.ctypeslib.as_array((ctypes.c_int16 * n).from_address(ptr))
    return torch.from_numpy(raw).view(torch.bfloat16)


def _store(ptr, n, dt, value):
    _view(ptr, n, dt).copy_(value.reshape(-1).to(torch.float32 if dt == 0 else torch.bfloat16))


def register_partials(h: torch.Tensor, hw: int, groups: int, bm: int, segmax: int) -> torch.Tensor:
    """The GroupNorm partials as the bf16 conv's register epilogue
    (finish_registers) indexes them: per tile and 192-wide N tile, each
    row's 8-column block sums; a group is blocks q // (cg // 8); the means
    sit at gmean[segment * 8 + group] of an (8 · segmax) buffer, then the
    squared deviations from them are summed the same way.  Groups it does
    not take land on each other's means or past the buffer."""
    m, co = h.shape
    cg = co // groups
    qg = cg // 8
    out = torch.zeros(-(-m // bm), groups, segmax, 3, dtype=torch.float64)
    for mt in range(out.shape[0]):
        m0 = mt * bm
        rows = min(bm, m - m0)
        b0 = m0 // hw
        nseg = (m0 + rows - 1) // hw - b0 + 1
        seg = [(m0 + r) // hw - b0 for r in range(rows)]
        for n0 in range(0, co, fr.TILE_N):
            cols = min(fr.TILE_N, co - n0)
            ng = cols // cg
            tile = h[m0:m0 + rows, n0:n0 + cols].double().reshape(rows, cols // 8, 8)
            gmean = torch.zeros(8 * segmax, dtype=torch.float64)
            for pass_ in (0, 1):
                v = tile
                if pass_:
                    g_of = torch.arange(cols // 8) // qg
                    inside = (g_of < ng).expand(rows, -1)
                    idx = torch.where(inside, torch.tensor(seg)[:, None] * 8 + g_of, 0)
                    v = (tile - torch.where(inside, gmean[idx], 0.0)[:, :, None]) ** 2
                rowsum = v.sum(-1)
                for i in range(nseg * ng):
                    sgm, g = divmod(i, ng)
                    ra, rb = max(m0, (b0 + sgm) * hw) - m0, min(m0 + rows, (b0 + sgm + 1) * hw) - m0
                    a, n = rowsum[ra:rb, g * qg:(g + 1) * qg].sum(), (rb - ra) * cg
                    if pass_ == 0:
                        gmean[sgm * 8 + g] = a / n
                    else:
                        out[mt, n0 // cg + g, sgm] = torch.stack([a.new_tensor(float(n)), gmean[sgm * 8 + g], a])
    return out.float()


def merge_in_order(parts, eps):
    """Chan's merge from zero of ``parts`` (count, mean, M2) rows of
    (G,) float32 values, in order (gn_merge_plain's arithmetic); (mean,
    rstd)."""
    n = mu = m2 = torch.zeros(parts[0].shape[0])
    for nb, mb, m2b in (p.unbind(-1) for p in parts):
        nt = n + nb
        d = mb - mu
        mu = mu + d * (nb / nt)
        m2 = m2 + m2b + d * d * (n * nb / nt)
        n = nt
    return mu, 1.0 / torch.sqrt(m2 / n + eps)


def apply_norm(h, mean, scale, beta, emb, res):
    """gn_silu's output in float64: SiLU((h − mean) · scale + beta) (+ emb)
    (+ res), h (B, HW, C), mean and scale (B, C) float32 tables."""
    y = F.silu((h.double() - mean[:, None].double()) * scale[:, None].double() + beta.double())
    if emb is not None:
        y = y + emb[:, None].double()
    if res is not None:
        y = y + res.double()
    return y


class _EmulatedKernels:
    """The C entry points of csrc/fused_resnet.cu on host memory, by what
    each kernel computes (in float64), with the kernels' own tiling."""

    def __init__(self):
        self.calls = []
        self.tiles = set()  # the bm of every tensor-core conv
        self.n_tiles = []  # the N tile of every 3xTF32 conv
        self.epilogues = []  # bf16 convs with GroupNorm (partials or fused): (staged, splits)
        self.fused = []  # fused bf16 convs: (cluster, multicast, staged)
        self.grid_y = []  # the y extent of every gn_silu launch

    def __call__(self, name, *args):
        self.calls.append(name)
        getattr(self, name)(*args)

    @staticmethod
    def _conv(x, w_kco, ks):
        return im2col(x.double(), ks) @ w_kco.double()

    def nope_conv_wgmma(self, x, w, bias, bdt, out, part, ws, b, h, wd, cin, co, ks, groups, tile, bm, rows,
                        samples, staged, splits, segmax, cluster, multicast, gamma, beta, emb, res, rdt, dst, eps):
        """A by the kernel's TMA boxes (box_cols), B by its weight tiles;
        the partials of a tile finished from registers as finish_registers
        indexes them.  Fused (dst given): each unit's tiles (its cluster's,
        in rank order, when a tile holds part of a sample) merge their
        partials, and the tile is normalised into bf16 dst."""
        m, k, hw = b * h * wd, ks * ks * cin, h * wd
        assert cin % 64 == 0 and co % 8 == 0  # what the C entry point takes
        assert tile in fr.TENSOR_CORE_ROUTES[torch.bfloat16].tiles and staged in (0, 1)
        assert 1 <= rows <= h and h % rows == 0 and samples >= 1 and (samples == 1 or rows == h)
        assert bm == wd * rows * samples <= tile and max(wd, rows, samples) <= 256
        assert 1 <= cluster <= fr.MAX_CLUSTER and (not multicast or cluster % 2 == 0)  # multicast pairs
        self.tiles.add(bm)
        xs = _view(x, m * cin, 1).reshape(b, h, wd, cin)
        wt = _view(w, co * k, 1).reshape(co, k)
        cols = box_cols(xs.double(), ks, bm, rows, samples)
        kt = k // 64
        acc = torch.zeros(m, co, dtype=torch.float64)
        for s in range(splits):  # the split ranges of the kernel, summed in order
            lo, hi = 64 * (s * kt // splits), 64 * ((s + 1) * kt // splits)
            if splits > 1:
                _store(ws + 4 * s * m * co, m * co, 0, cols[:, lo:hi] @ wt[:, lo:hi].double().t())
            acc += cols[:, lo:hi] @ wt[:, lo:hi].double().t()
        res_h = (acc + _view(bias, co, bdt).double()).float()
        fused = dst is not None
        if fused:  # what the C entry point takes
            assert out is None and part is None and splits == 1 and staged and fr.register_groups(co, groups)
            assert cluster * bm == hw if bm < hw else bm % hw == 0 and segmax <= fr.FUSE_SEGS
            self.fused.append((cluster, multicast, staged))
        else:
            _store(out, m * co, 0, res_h)
        if part is None and not fused:
            return
        self.epilogues.append((staged, splits))
        registers = not staged and splits == 1
        if registers:  # what the C entry point refuses: register_groups
            cg = co // groups
            assert cg % 8 == 0 and min(co, 192) // cg <= 8, f"{groups} groups of {co} from registers"
        p = register_partials(res_h, hw, groups, bm, segmax) if registers else fr.gn_partials_plain(res_h, hw, groups,
                                                                                                    bm)
        assert p.shape[2] == segmax
        if not fused:
            _store(part, p.numel(), 0, p)
            return
        # the kernel's units: `parts` tiles of one sample in rank order, or one tile of whole samples
        parts = cluster if bm < hw else 1
        mean, scale = torch.empty(b, co), torch.empty(b, co)
        gam = _view(gamma, co, 1).float()
        for mt0 in range(0, p.shape[0], parts):
            for seg in range(segmax):
                sample = mt0 * bm // hw + seg
                if sample >= b or sample * hw >= mt0 * bm + parts * bm:
                    continue
                mu, rstd = merge_in_order([p[mt0 + r, :, seg] for r in range(parts)], eps)
                mean[sample] = mu.repeat_interleave(co // groups)
                scale[sample] = rstd.repeat_interleave(co // groups) * gam
        y = apply_norm(res_h.reshape(b, hw, co), mean, scale, _view(beta, co, 1),
                       None if emb is None else _view(emb, b * co, 1).reshape(b, co),
                       None if res is None else _view(res, m * co, rdt).reshape(b, hw, co))
        _store(dst, m * co, 1, y)

    def nope_conv_tf32x3(self, x, w, bias, bdt, out, part, ws, b, h, wd, cin, co, ks, groups, bm, bn, splits,
                         segmax):
        """The split arithmetic: x and the pack's planes as the tensor
        cores read them (lo truncated), lo·hi + hi·lo + hi·hi per split of
        32-deep K-slices, the splits summed in order."""
        m, k = b * h * wd, ks * ks * cin
        assert cin % 32 == 0 and co % 8 == 0  # what the C entry point takes
        assert bn == fr.TILE_N or (bn == fr.TILE_N_FREE and part is None)
        self.tiles.add(bm)
        self.n_tiles.append(bn)
        xh, xl = fr.tf32_split(_view(x, m * cin, 0).reshape(b, h, wd, cin))
        x_hi, x_lo = im2col(xh.double(), ks), im2col(fr.tf32_truncate(xl).double(), ks)
        pack = _view(w, 2 * co * k, 0).reshape(2, co, k)
        w_hi, w_lo = pack[0].double(), fr.tf32_truncate(pack[1]).double()
        kt = k // 32
        acc = torch.zeros(m, co, dtype=torch.float64)
        for s in range(splits):
            sl = slice(32 * (s * kt // splits), 32 * ((s + 1) * kt // splits))
            p = x_lo[:, sl] @ w_hi[:, sl].t() + x_hi[:, sl] @ w_lo[:, sl].t() + x_hi[:, sl] @ w_hi[:, sl].t()
            if splits > 1:
                _store(ws + 4 * s * m * co, m * co, 0, p)
            acc += p
        res = (acc + _view(bias, co, bdt).double()).float()
        _store(out, m * co, 0, res)
        if part is not None:
            p = fr.gn_partials_plain(res, h * wd, groups, bm)
            assert p.shape[2] == segmax
            _store(part, p.numel(), 0, p)

    def nope_gn_finalize(self, part, gamma, pdt, mean, scale, b, hw, c, groups, bm, segmax, eps):
        n = -(-b * hw // bm) * groups * segmax * 3
        p = _view(part, n, 0).reshape(-1, groups, segmax, 3).clone()
        cg = c // groups
        for sample in range(b):  # gn_finalize: per (sample, group), its tiles' partials in tile order
            mu, rstd = merge_in_order([p[mt, :, sample - mt * bm // hw]
                                       for mt in range(sample * hw // bm, ((sample + 1) * hw - 1) // bm + 1)], eps)
            _view(mean, b * c, 0)[sample * c:(sample + 1) * c] = mu.repeat_interleave(cg)
            _view(scale, b * c, 0)[sample * c:(sample + 1) * c] = rstd.repeat_interleave(cg) * _view(gamma, c, pdt).float()

    def nope_group_stats(self, hp, gamma, pdt, mean, scale, b, hw, c, groups, eps):
        hg = _view(hp, b * hw * c, 0).reshape(b, hw, groups, c // groups).double()
        mu, var = hg.mean((1, 3)), hg.var((1, 3), unbiased=False)
        cg = c // groups
        _store(mean, b * c, 0, mu.repeat_interleave(cg, 1))
        _store(scale, b * c, 0, (var + eps).rsqrt().repeat_interleave(cg, 1) * _view(gamma, c, pdt).double())

    def nope_gn_silu(self, hp, mean, scale, beta, pdt, emb, edt, res, rdt, out, odt, b, hw, c, grid_y):
        assert grid_y == _build.grid_y(b)
        self.grid_y.append(grid_y)
        y = apply_norm(_view(hp, b * hw * c, 0).reshape(b, hw, c), _view(mean, b * c, 0).reshape(b, c),
                       _view(scale, b * c, 0).reshape(b, c), _view(beta, c, pdt),
                       None if emb is None else _view(emb, b * c, edt).reshape(b, c),
                       None if res is None else _view(res, b * hw * c, rdt).reshape(b, hw, c))
        dst = _view(out, b * hw * c, odt).reshape(b, hw, c)
        for block_y in range(grid_y):  # each block of the y axis strides over the samples
            for sample in range(block_y, b, grid_y):
                dst[sample] = y[sample].to(dst.dtype)

    def nope_conv_nhwc(self, x, w, bias, out, b, h, wd, cin, co, ks, xdt, wdt):
        xs = _view(x, b * h * wd * cin, xdt).reshape(b, h, wd, cin)
        wt = _view(w, ks * ks * cin * co, wdt).reshape(-1, co)
        _store(out, b * h * wd * co, 0, self._conv(xs, wt, ks) + _view(bias, co, wdt).double())


@pytest.mark.parametrize("route,batch,hw_side,cin,co,with_res,with_emb,sms", [
    ("tensor_cores", 3, 4, 128, 192, True, True, 132),   # ragged M; 64-row tiles over 4 samples, split K
    ("tensor_cores", 2, 8, 192, 192, False, False, 132),
    ("tensor_cores", 6, 8, 64, 384, True, False, 2),     # 192-row tiles cutting samples (2 SMs)
    ("tensor_cores", 15, 4, 192, 192, False, True, 1),   # 64-row tiles, ragged (1 SM)
    ("tensor_cores", 35, 4, 192, 192, False, True, 1),   # 128-row tiles of 8 samples, the last past B (1 SM)
    ("tensor_cores", 5, 4, 128, 192, True, True, 1),     # one 128-row tile of 8 samples over B = 5 (1 SM)
    ("tensor_cores", 11, 8, 64, 192, True, True, 1),     # 128-row tiles of 2 samples, the last past B (1 SM)
    ("tensor_cores", 2, 16, 64, 192, True, False, 1),    # 128-row tiles of 8 rows of 16x16 (1 SM)
    ("cuda_cores", 2, 4, 16, 24, True, True, 132),
    ("cuda_cores", 2, 4, 24, 24, False, False, 132),
    ("cuda_cores_bf16", 2, 4, 16, 24, True, True, 132),  # bf16 at widths the bf16 tiles do not take
    ("cuda_cores_bf16", 3, 4, 96, 192, True, False, 132),
    ("tf32x3", 3, 4, 96, 192, True, True, 132),  # ragged M; one 64-row tile over 3 samples, K split in 6
    ("tf32x3", 2, 8, 32, 96, True, False, 132),  # Co = 96: rows past Co in the N tile
    ("tf32x3", 6, 6, 64, 384, True, False, 2),  # 128-row tiles cutting samples, ragged (2 SMs)
    ("tf32x3", 15, 4, 192, 192, False, True, 4),  # 64-row tiles, ragged (4 SMs)
    ("tf32x3", 31, 4, 192, 192, False, True, 1),  # 128-row tiles of 8 samples, ragged (1 SM)
])
def test_block_launches_match_the_plain_block(monkeypatch, route, batch, hw_side, cin, co, with_res,
                                               with_emb, sms):
    _check_block_launches(monkeypatch, route, batch, hw_side, cin, co, with_res, with_emb, sms)


# (B, side, Cin, Co, groups, staged): the first conv's 216 K-slices in one
# split (1 SM) take the register epilogue unless the groups need the staged
# one (the second conv's 36 or 108 at Co = 256 or 768 stage by K)
@pytest.mark.parametrize("batch,hw_side,cin,co,groups,staged", [
    (3, 8, 1536, 256, 8, 0),    # cg = 32: 6 groups, then 2 in the last 64 columns
    (3, 8, 1536, 256, 32, 1),   # cg = 8: 24 groups in the first N tile
    (3, 4, 1536, 768, 64, 1),   # cg = 12: groups straddle 8-column blocks
    (5, 4, 1536, 768, 32, 0),   # cg = 24: 8 groups an N tile, 8 samples a tile, the last past B
])
def test_block_launches_take_any_groups(monkeypatch, batch, hw_side, cin, co, groups, staged):
    """Every GroupNorm width the route takes (cg | 192) gives the plain
    block; the register epilogue gets only the groups it can index."""
    emulated = _check_block_launches(monkeypatch, "tensor_cores", batch, hw_side, cin, co, cin != co, True, 1,
                                     groups)
    assert emulated.epilogues[0] == (staged, 1) and len(emulated.epilogues) == 2


@pytest.mark.parametrize("route", ["tensor_cores", "cuda_cores", "tf32x3"])
@pytest.mark.parametrize("max_grid_y", [1, 2, 4])
def test_block_launches_stride_past_the_grid_limit(monkeypatch, route, max_grid_y):
    """With the grid's y extent capped below B, each gn_silu block strides
    over several samples, and the block is still the plain one."""
    monkeypatch.setattr(_build, "MAX_GRID_Y", max_grid_y)
    cin, co = (16, 24) if route == "cuda_cores" else (128, 192)
    emulated = _check_block_launches(monkeypatch, route, 5, 4, cin, co, True, True, 132)
    assert emulated.grid_y == [max_grid_y, max_grid_y]


# route under test: (the wrapper's function, dtype, its C conv entry point)
ROUTES = {"tensor_cores": ("_block_tensor_cores", torch.bfloat16, "nope_conv_wgmma"),
          "tf32x3": ("_block_tensor_cores", torch.float32, "nope_conv_tf32x3"),
          "cuda_cores": ("_block_cuda_cores", torch.float32, "nope_conv_nhwc"),
          "cuda_cores_bf16": ("_block_cuda_cores", torch.bfloat16, "nope_conv_nhwc")}


def _check_block_launches(monkeypatch, route, batch, hw_side, cin, co, with_res, with_emb, sms, groups=8):
    emulated = _EmulatedKernels()

    @contextlib.contextmanager
    def launcher(device):
        yield emulated

    monkeypatch.setattr(_build, "launcher", launcher)
    monkeypatch.setattr(_build, "sm_count", lambda device: sms)
    gen = torch.Generator().manual_seed(batch * co + cin)
    block, dtype, conv = ROUTES[route]
    x = torch.randn(batch, hw_side, hw_side, cin, generator=gen).to(dtype)
    emb = torch.randn(batch, co, generator=gen).to(dtype) if with_emb else None
    p = {"w1": torch.randn(co, cin, 3, 3, generator=gen) / (9 * cin) ** 0.5, "b1": 0.1 * torch.randn(co, generator=gen),
         "g1": 0.5 + torch.rand(co, generator=gen), "be1": 0.1 * torch.randn(co, generator=gen),
         "w2": torch.randn(co, co, 3, 3, generator=gen) / (9 * co) ** 0.5, "b2": 0.1 * torch.randn(co, generator=gen),
         "g2": 0.5 + torch.rand(co, generator=gen), "be2": 0.1 * torch.randn(co, generator=gen)}
    if with_res:
        p["res_w"] = torch.randn(co, cin, 1, 1, generator=gen) / cin ** 0.5
        p["res_b"] = 0.1 * torch.randn(co, generator=gen)
    p = {k: v.to(dtype) for k, v in p.items()}
    out = torch.empty(batch, hw_side, hw_side, co, dtype=dtype)
    before = profiling.counters()
    getattr(fr, block)(x, emb, p, groups, 1e-5, out)
    want = fr.resnet_block_plain(x.float(), None if emb is None else emb.float(),
                                 {k: v.float() for k, v in p.items()}, groups)
    # bf16: act and the output are rounded to bf16 (the chip's tolerance);
    # float32: the emulation sums in float64; 3xTF32: the chip's float32
    # tolerance (each product's dropped terms are ~2^-21 of it)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4 if route == "tf32x3" else 1e-5
    err = (out.float() - want).abs().max() / want.abs().max()
    assert err <= tol, err
    emulated.out = out
    assert emulated.calls.count(conv) == 2 + with_res
    assert {"nope_conv_wgmma", "nope_conv_tf32x3", "nope_conv_nhwc"} & set(emulated.calls) == {conv}
    if block == "_block_tensor_cores":
        r = fr.TENSOR_CORE_ROUTES[dtype]
        plan = fr.conv_plan(batch * hw_side ** 2, hw_side ** 2, co, 9 * cin // r.slice_k, sms, r, hw_side)
        assert emulated.tiles == {plan.bm}
        fused = [p.fused for p in (fr.conv_plan(batch * hw_side ** 2, hw_side ** 2, co, 9 * c // r.slice_k, sms, r,
                                                hw_side, groups) for c in (cin, co))]
        assert len(emulated.fused) == sum(fused) and emulated.calls.count("nope_gn_silu") == 2 - sum(fused)
    bf16_tc, tf32x3 = route == "tensor_cores", route == "tf32x3"
    assert [profiling.counters().get(k, 0) - before.get(k, 0)
            for k in ("k3.tensor_core_launches", "k3.tf32x3_launches")] == [bf16_tc, tf32x3]
    return emulated


# (B, side, Cin, Co, res, emb, SMs): bf16 blocks whose convs fuse, and what their plans give:
# a sample in a cluster of 8, 4 or 2 staged tiles (no multicast, then multicast pairs), a tile of 8,
# 4 or 2 whole samples, a multicast pair with a ghost tile
FUSED_BLOCKS = [
    (2, 32, 192, 192, False, True, 16),  # 32x32: 8 tiles of 4 rows a sample
    (2, 32, 64, 192, True, False, 1),    # the same, multicasting the weight tile across the 8
    (2, 16, 64, 192, True, True, 8),     # 16x16: 4 tiles of 4 rows
    (2, 16, 192, 192, False, False, 4),  # 16x16: 2 tiles of 8 rows
    (3, 16, 64, 192, True, True, 1),     # 16x16: 2 tiles, multicast
    (5, 4, 768, 192, True, True, 2),     # 4x4: 4 samples a tile, conv 1's 108 K-slices staged too
    (5, 4, 192, 192, False, True, 1),    # 4x4: 8 samples a tile, the last past B, staged
    (13, 8, 64, 192, True, False, 1),    # 8x8: 2 samples a tile, a pair with a ghost tile
]


@pytest.mark.parametrize("batch,hw_side,cin,co,with_res,with_emb,sms", FUSED_BLOCKS)
def test_fused_block_launches_equal_the_chain(monkeypatch, batch, hw_side, cin, co, with_res, with_emb, sms):
    """A fused block gives the chain's bits (the same partials, merged in
    the same order with the same arithmetic), launches no gn_finalize or
    gn_silu and holds no float32 conv scratch; both match the plain
    block."""
    sizes = []
    scratch = fr._Scratch

    def spy(device, **kw):
        sizes.append(kw)
        return scratch(device, **kw)

    monkeypatch.setattr(fr, "_Scratch", spy)
    before = profiling.counters().get("k3.fused_norms", 0)
    fused = _check_block_launches(monkeypatch, "tensor_cores", batch, hw_side, cin, co, with_res, with_emb, sms)
    got = fused.out
    assert profiling.counters()["k3.fused_norms"] == before + 2
    assert len(fused.fused) == 2 and not {"nope_gn_finalize", "nope_gn_silu"} & set(fused.calls)
    assert sizes[-1]["conv"] == 0 and sizes[-1]["part"] == 0 and sizes[-1]["mean"] == 0
    r = fr.TENSOR_CORE_ROUTES[torch.bfloat16]
    plan = fr.conv_plan(batch * hw_side ** 2, hw_side ** 2, co, 9 * cin // 64, sms, r, hw_side, 8)
    assert fused.fused[0] == (plan.cluster, plan.multicast, plan.staged)

    chain_plan = fr.conv_plan
    monkeypatch.setattr(fr, "conv_plan", lambda *a, **k: chain_plan(*a, **{**k, "fuse": False}))
    chain = _check_block_launches(monkeypatch, "tensor_cores", batch, hw_side, cin, co, with_res, with_emb, sms)
    assert not chain.fused and chain.calls.count("nope_gn_silu") == 2 and sizes[-1]["conv"] > 0
    assert profiling.counters()["k3.fused_norms"] == before + 2
    torch.testing.assert_close(got, chain.out, rtol=0, atol=0)


@pytest.mark.parametrize("batch,side,cin,co,n_tile", [
    (2, 4, 64, 128, 128),   # the SD-VAE's widths: 128-column tiles, K split over the few M tiles
    (3, 8, 32, 256, 128),
    (2, 4, 64, 96, 128),    # rows past Co in a 128 tile
    (2, 4, 64, 192, 192),   # 192 fills its tile: kept
    (2, 4, 32, 384, 192),   # a tie: kept
])
def test_partial_free_conv_launches_its_n_tile(batch, side, cin, co, n_tile):
    """A 3xTF32 conv without GroupNorm partials (``conv_tf32x3``'s launch)
    passes the N tile ``n_tile`` chose, and gives the split arithmetic."""
    emulated = _EmulatedKernels()
    route = fr.TENSOR_CORE_ROUTES[torch.float32]
    gen = torch.Generator().manual_seed(co + cin)
    x = torch.randn(batch, side, side, cin, generator=gen)
    w = torch.randn(co, cin, 3, 3, generator=gen) / (9 * cin) ** 0.5
    b = 0.1 * torch.randn(co, generator=gen)
    m = batch * side * side
    plan = fr.conv_plan(m, side * side, co, 9 * cin // route.slice_k, 132, route)
    out = torch.empty(batch, side, side, co)
    ws = torch.empty(plan.splits * m * co)
    fr._conv_tensor_cores(emulated, route, x.data_ptr(), fr.packed_weight(w, route.layout), b, out.data_ptr(), None,
                          ws.data_ptr() if plan.splits > 1 else None, x.shape, 3, 1, plan)
    assert emulated.n_tiles == [n_tile] and fr.n_tile(route, co, False) == n_tile
    want = fr.conv_tf32x3_plain(x, w, b)
    assert ((out - want).abs().max() / want.abs().max()).item() <= 1e-6


@pytest.mark.parametrize("cin,co,n_tiles", [
    (96, 192, [192, 192, 192]),     # the flagship U-Net's residual widths: 192 fills its tiles,
    (192, 384, [192, 192, 192]),    # and 384, 768 and 1536 tie, so the residual keeps 192
    (384, 768, [192, 192, 192]),
    (768, 1536, [192, 192, 192]),
    (128, 256, [192, 128, 192]),    # 256: the residual alone takes 128-column tiles
])
def test_k3_residual_conv_is_partial_free(monkeypatch, cin, co, n_tiles):
    """A float32 K3 block's 1x1 residual conv writes no GroupNorm partials,
    so it takes :func:`fr.n_tile`'s tile: 192 at the flagship's widths,
    128 where that leaves fewer columns empty; its two 3x3 convs keep 192."""
    emulated = _check_block_launches(monkeypatch, "tf32x3", 2, 4, cin, co, True, True, 132)
    assert emulated.n_tiles == n_tiles  # conv1, the residual, conv2
    assert fr.n_tile(fr.TENSOR_CORE_ROUTES[torch.float32], co, False) == n_tiles[1]
