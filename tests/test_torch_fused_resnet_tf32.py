"""K3's float32 tensor-core route (3xTF32) in plain torch on the CPU: the
tf32 split of the ``"co_k_tf32x3"`` weight pack (bits, rounding, ties,
in-place updates), the split conv's precision at the widest K of the
flagship U-Net against float64 and the JAX package's conv, its tiling
plan, and which route a block takes.  The block's launches against an
emulation of ``nope_conv_tf32x3`` are in
``tests/test_torch_fused_resnet_layout.py``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from nope_tpu_torch.ops import _build
from nope_tpu_torch.ops import fused_resnet as fr

torch.set_num_threads(1)

TF32X3 = fr.TENSOR_CORE_ROUTES[torch.float32]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """float32 to 10 mantissa bits, to nearest with ties away from zero,
    in float64 arithmetic (the reference of ``cvt.rna.tf32.f32``)."""
    x = x.astype(np.float64)
    _, e = np.frexp(x)  # x = f · 2^e, 0.5 <= |f| < 1
    # 11 significant bits (1 + 10); a subnormal keeps the top 10 bits of
    # its fraction field, a grid of 2^-136
    ulp = np.maximum(np.ldexp(1.0, e - 11), 2.0 ** -136)
    return np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp


def test_split_planes_sum_to_the_weight_bit_for_bit():
    rng = np.random.default_rng(0)
    w = np.concatenate([
        rng.normal(size=4000), 1e-3 * rng.normal(size=1000), 1e6 * rng.normal(size=1000),
        rng.uniform(1e-40, 1e-38, 200) * rng.choice([-1, 1], 200),  # subnormals
        [0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38, 1.17549435e-38],
    ]).astype(np.float32)
    hi, lo = fr.tf32_split(torch.from_numpy(w))
    assert hi.dtype == lo.dtype == torch.float32
    # bit for bit; -0.0 splits as -0.0 + 0.0, which sums to 0.0
    np.testing.assert_array_equal(_bits(hi + lo)[w != 0], _bits(torch.from_numpy(w))[w != 0])
    np.testing.assert_array_equal((hi + lo).numpy(), w)
    assert not (_bits(hi) & 0x1FFF).any()  # hi's low 13 mantissa bits are 0
    finite = np.isfinite(hi.numpy())
    np.testing.assert_array_equal(hi.numpy()[finite], _round_half_away(w)[finite].astype(np.float32))
    # lo is what hi leaves: at most half of hi's last place (2^-136 for a subnormal)
    assert (np.abs(lo.numpy()) <= np.maximum(np.abs(w) * 2.0 ** -11, 2.0 ** -137)).all()


def test_rounding_is_to_nearest_with_ties_away_from_zero():
    """Hand-made ties: 1 + 2^-11 lies halfway between 1 and 1 + 2^-10 (to
    nearest-even it would be 1); one float32 step either side rounds to
    the nearer; a tie at the top of a binade carries into the exponent."""
    e = 2.0 ** -11
    cases = {
        1 + e: 1 + 2 * e, -(1 + e): -(1 + 2 * e),
        1 + e - 2.0 ** -23: 1.0, 1 + e + 2.0 ** -23: 1 + 2 * e,
        1 + 3 * e: 1 + 4 * e,  # a tie above an odd last place
        2 - e: 2.0, -(2 - e): -2.0,
        3.0 * 2.0 ** -130 + 2.0 ** -140: 3.0 * 2.0 ** -130,  # a subnormal keeps 10 bits of its fraction
        3.0 * 2.0 ** -130 + 2.0 ** -137: 3.0 * 2.0 ** -130 + 2.0 ** -136,  # ... and its ties round away too
    }
    x = torch.tensor(list(cases), dtype=torch.float32)
    hi, lo = fr.tf32_split(x)
    np.testing.assert_array_equal(hi.numpy(), np.array(list(cases.values()), np.float32))
    np.testing.assert_array_equal((hi + lo).numpy(), x.numpy())
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    assert torch.equal(fr.tf32_split(special)[0][:2], special[:2]) and fr.tf32_split(special)[0][2].isnan()
    with pytest.raises(TypeError):
        fr.tf32_split(x.to(torch.bfloat16))


def test_truncation_drops_the_low_13_bits():
    x = torch.tensor([1 + 2.0 ** -11 + 2.0 ** -20, -(1 + 2.0 ** -10 + 2.0 ** -13)], dtype=torch.float32)
    np.testing.assert_array_equal(fr.tf32_truncate(x).numpy(), np.array([1.0, -(1 + 2.0 ** -10)], np.float32))


def test_tf32x3_pack_is_the_split_co_k_and_follows_in_place_updates():
    conv = torch.nn.Conv2d(64, 96, 3)
    pack = fr.packed_weight(conv.weight, "co_k_tf32x3")
    assert pack.shape == (2, 96, 9 * 64) and pack.dtype == torch.float32 and pack.is_contiguous()
    co_k = fr.packed_weight(conv.weight, "co_k")
    np.testing.assert_array_equal(_bits(pack[0] + pack[1]), _bits(co_k))
    assert not (_bits(pack[0]) & 0x1FFF).any()
    assert fr.packed_weight(conv.weight, "co_k_tf32x3") is pack  # made once
    with torch.no_grad():
        conv.weight.mul_(3.0)  # an optimizer step: the pack is dropped and made again
    again = fr.packed_weight(conv.weight, "co_k_tf32x3")
    assert again is not pack
    np.testing.assert_array_equal(_bits(again[0] + again[1]), _bits(3.0 * co_k))
    conv.to(torch.bfloat16)
    with pytest.raises(TypeError):
        fr.packed_weight(conv.weight, "co_k_tf32x3")


def test_split_conv_at_the_widest_k_is_float32_accurate():
    """An up block's first conv at 4x4: 1536 + 768 = 2304 channels in, K
    = 9 x 2304, over 256 output pixels: the three tf32 products are within
    rel 1e-5 of a float64 conv, as close as the JAX package's float32
    conv at highest precision, and far closer than one bf16 pass (the
    TPU's float32 K3)."""
    rng = np.random.default_rng(7)
    cin, co = 2304, 192
    x = rng.normal(size=(16, 4, 4, cin)).astype(np.float32)
    w = (rng.normal(size=(co, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    b = (0.1 * rng.normal(size=co)).astype(np.float32)
    exact = F.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2), torch.from_numpy(w).double(),
                     torch.from_numpy(b).double(), padding=1).permute(0, 2, 3, 1).numpy()
    got = fr.conv_tf32x3_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    assert got.shape == (16, 4, 4, co) and got.dtype == np.float32
    scale = np.abs(exact).max()
    rel = np.abs(got - exact).max() / scale
    assert rel <= 1e-5, rel
    w_hwio = jnp.asarray(np.transpose(w, (2, 3, 1, 0)))
    with jax.default_matmul_precision("highest"):
        jax_f32 = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), w_hwio, (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"))) + b
    jax_rel = np.abs(jax_f32 - exact).max() / scale
    assert rel <= 10 * max(jax_rel, 1e-7), (rel, jax_rel)
    one_pass = F.conv2d(torch.from_numpy(x).bfloat16().double().permute(0, 3, 1, 2),
                        torch.from_numpy(w).bfloat16().double(), torch.from_numpy(b).double(), padding=1)
    bf16_rel = np.abs(one_pass.permute(0, 2, 3, 1).numpy() - exact).max() / scale
    assert rel < bf16_rel / 100, (rel, bf16_rel)


@pytest.mark.parametrize("ks", [3, 1])
def test_conv_tf32x3_takes_the_plain_version_on_the_cpu(monkeypatch, ks):
    gen = torch.Generator().manual_seed(ks)
    x = torch.randn(2, 5, 6, 32, generator=gen)
    w = torch.randn(40, 32, ks, ks, generator=gen) / (ks * ks * 32) ** 0.5
    b = torch.randn(40, generator=gen)
    entered = []
    monkeypatch.setattr(_build, "launcher", lambda device: entered.append(device))
    got = fr.conv_tf32x3(x, w, b)
    assert torch.equal(got, fr.conv_tf32x3_plain(x, w, b))
    assert not entered  # no kernel ran
    want = F.conv2d(x.double().permute(0, 3, 1, 2), w.double(), b.double(), padding=ks // 2).permute(0, 2, 3, 1)
    assert ((got.double() - want).abs().max() / want.abs().max()).item() <= 1e-6
    with pytest.raises(ValueError):
        fr.conv_tf32x3(x, torch.randn(40, 32, 5, 5), b)


@pytest.mark.parametrize("m,hw,co,k_slices,want", [
    (26 * 1024, 1024, 192, 54, (128, 1, 2)),    # 32x32 at B=26: 208 tiles of 128 rows, 2 waves of one an SM
    (341 * 1024, 1024, 192, 54, (128, 1, 2)),   # 32x32 at B=341: as many waves as 64 rows, fewer bytes
    (1364 * 1024, 1024, 192, 54, (128, 1, 2)),  # the BOP bank at batch 4
    (26 * 256, 256, 192, 54, (64, 1, 2)),       # 16x16 at B=26: 104 tiles fill the card once, no split
    (26 * 16, 16, 768, 216, (64, 4, 5)),        # 4x4 at B=26: 28 tiles, K split in 4 (one block an SM)
    (341 * 16, 16, 768, 216, (64, 1, 5)),       # 4x4 at B=341: 3 waves of 64 rows beat 2 of 128
    (3 * 16, 16, 768, 12, (64, 3, 5)),          # a 1x1 of 384 channels: 12 slices, 3 splits of 4
])
def test_conv_plan_tf32x3(m, hw, co, k_slices, want):
    """The 3xTF32 route's plan: 32-deep K-slices, tiles of 64 or 128 rows,
    one block to an SM either way; A is gathered (no TMA box, no staging),
    and it keeps the GroupNorm chain (no cluster, no fused epilogue)."""
    assert tuple(fr.conv_plan(m, hw, co, k_slices, 132, TF32X3, groups=8)) == (*want, want[0], 0, 0, 0, 1, 0, 0)


@pytest.mark.parametrize("dtype,c_in,c_out,fits", [
    (torch.float32, 192, 192, True), (torch.float32, 2304, 1536, True),  # flagship widths
    (torch.float32, 96, 192, True), (torch.bfloat16, 96, 192, False),    # 32-channel slices in float32 only
    (torch.float32, 192, 200, False),  # act's 200 channels are no whole slices
    (torch.float32, 16, 24, False), (torch.bfloat16, 128, 192, True),
    (torch.float16, 192, 192, False),
])
def test_which_route_a_block_takes(dtype, c_in, c_out, fits):
    assert fr._tensor_core_fits(c_in, c_out, 8, dtype) is fits
