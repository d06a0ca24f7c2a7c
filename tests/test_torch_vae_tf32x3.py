"""The float32 SD-VAE's 3xTF32 route, in plain torch on the CPU: which convs
``fused_resnet.tf32x3_routes`` takes (the SD-VAE encoder's, and none in
bf16, on the CPU or with a gradient), the NHWC GroupNorm + SiLU against
``nn.GroupNorm`` + ``F.silu``, a reduced-width encoder whose routed convs
run ``conv_tf32x3_plain`` against the same encoder on ``F.conv2d``, and
the N tile the plan gives a conv that writes no GroupNorm partials."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from nope_tpu_torch.models import vae as vae_module
from nope_tpu_torch.models.vae import StableDiffusionVAE
from nope_tpu_torch.ops import fused_resnet as fr
from nope_tpu_torch.utils import profiling

torch.set_num_threads(1)

TF32X3 = fr.TENSOR_CORE_ROUTES[torch.float32]

# the SD-VAE encoder's convs at (128, 256, 512, 512) that take the route: the
# resnets' twenty stride-1 3x3 convs and the two 1x1 shortcuts
SD_ROUTED = sorted(
    [f"encoder.down_blocks.{i}.resnets.{j}.conv{c}" for i in range(4) for j in range(2) for c in (1, 2)]
    + [f"encoder.mid_block.resnets.{j}.conv{c}" for j in range(2) for c in (1, 2)]
    + ["encoder.down_blocks.1.resnets.0.conv_shortcut", "encoder.down_blocks.2.resnets.0.conv_shortcut"])
# and those that keep cuDNN: 3 input channels, the stride-2 downsamplers, 8 output channels, 8 input channels
SD_CUDNN = sorted(["encoder.conv_in", "encoder.conv_out", "quant_conv"]
                  + [f"encoder.down_blocks.{i}.downsamplers.0.conv" for i in range(3)])


@pytest.mark.parametrize("dtype,device,grad,stride,padding,kernel,c_in,c_out,routed", [
    (torch.float32, "cuda", False, (1, 1), (1, 1), (3, 3), 128, 128, True),   # a stage-0 resnet conv
    (torch.float32, "cuda", False, (1, 1), (1, 1), (3, 3), 512, 512, True),
    (torch.float32, "cuda", False, (1, 1), (0, 0), (1, 1), 128, 256, True),   # a shortcut
    (torch.bfloat16, "cuda", False, (1, 1), (1, 1), (3, 3), 128, 128, False),  # bf16 keeps cuDNN
    (torch.float32, "cpu", False, (1, 1), (1, 1), (3, 3), 128, 128, False),    # the CPU keeps F.conv2d
    (torch.float32, "cuda", True, (1, 1), (1, 1), (3, 3), 128, 128, False),    # a gradient is asked
    (torch.float32, "cuda", False, (2, 2), (0, 0), (3, 3), 128, 128, False),   # a downsampler
    (torch.float32, "cuda", False, (1, 1), (0, 0), (3, 3), 128, 128, False),   # 3x3 without padding
    (torch.float32, "cuda", False, (1, 1), (2, 2), (5, 5), 128, 128, False),   # 5x5
    (torch.float32, "cuda", False, (1, 1), (1, 1), (3, 3), 3, 128, False),     # conv_in: 3 channels
    (torch.float32, "cuda", False, (1, 1), (1, 1), (3, 3), 512, 8, False),     # conv_out: 8 of a 128 tile
    (torch.float32, "cuda", False, (1, 1), (1, 1), (3, 3), 96, 192, False),    # 192 fills no 128 tiles
])
def test_route_rule(dtype, device, grad, stride, padding, kernel, c_in, c_out, routed):
    assert fr.tf32x3_routes(dtype, device, grad, stride, padding, kernel, c_in, c_out) is routed


def _sd_vae_convs():
    with torch.device("meta"):
        vae = StableDiffusionVAE()
    return {name: m for name, m in vae.named_modules()
            if isinstance(m, nn.Conv2d) and not name.startswith(("decoder", "post_quant"))}


def _route(conv, dtype, device, grad):
    return fr.tf32x3_routes(dtype, device, grad, conv.stride, conv.padding, conv.kernel_size, conv.in_channels,
                            conv.out_channels)


def test_sd_vae_encoder_routes_exactly_its_resnet_convs():
    convs = _sd_vae_convs()
    assert sorted(n for n, c in convs.items() if _route(c, torch.float32, "cuda", False)) == SD_ROUTED
    assert sorted(n for n, c in convs.items() if not _route(c, torch.float32, "cuda", False)) == SD_CUDNN
    assert len(SD_ROUTED) == 22 and len(SD_CUDNN) == 6


@pytest.mark.parametrize("dtype,device,grad", [(torch.bfloat16, "cuda", False), (torch.float32, "cpu", False),
                                               (torch.float32, "cuda", True)])
def test_sd_vae_encoder_routes_nothing_in_bf16_on_the_cpu_or_with_grad(dtype, device, grad):
    assert not any(_route(c, dtype, device, grad) for c in _sd_vae_convs().values())


@pytest.mark.parametrize("c,side", [(128, 16), (256, 8), (512, 4)])
def test_group_norm_film_silu_nhwc_matches_nn_group_norm(c, side):
    gen = torch.Generator().manual_seed(c)
    norm = nn.GroupNorm(32, c, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(0.5 + torch.rand(c, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(c, generator=gen))
    x = 2.0 + 3.0 * torch.randn(3, c, side, side, generator=gen)  # an offset mean: the statistics must not cancel
    with torch.no_grad():
        want = F.silu(norm(x))
        got = fr.group_norm_film_silu_nhwc(x.permute(0, 2, 3, 1).contiguous(), norm.weight, norm.bias, 32, 1e-6)
    assert got.shape == (3, side, side, c) and got.dtype == torch.float32 and got.is_contiguous()
    err = ((got.permute(0, 3, 1, 2) - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-6, err


@pytest.mark.parametrize("mean,std", [(50.0, 0.5), (500.0, 1.0)])
def test_group_norm_film_silu_nhwc_centres_a_mean_far_above_its_spread(mean, std):
    """Where a group's mean is 100 or 500 times its spread, the pair's
    float32 GroupNorm + SiLU strays from a float64 one no more than
    ``nn.GroupNorm``'s float32 does: x is centred before the scale, not
    folded into x·a + d, whose error grows with mean / std."""
    c, side = 128, 16
    gen = torch.Generator().manual_seed(9)
    norm = nn.GroupNorm(32, c, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(0.5 + torch.rand(c, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(c, generator=gen))
    x = mean + std * torch.randn(3, c, side, side, generator=gen)
    with torch.no_grad():
        exact = F.silu(F.group_norm(x.double(), 32, norm.weight.double(), norm.bias.double(), 1e-6))
        nn_err = (F.silu(norm(x)).double() - exact).abs().max().item()
        got = fr.group_norm_film_silu_nhwc(x.permute(0, 2, 3, 1).contiguous(), norm.weight, norm.bias, 32, 1e-6)
    err = (got.permute(0, 3, 1, 2).double() - exact).abs().max().item()
    assert err <= nn_err, (err, nn_err)


def _small_vae():
    """A reduced SD-VAE whose resnets take the route: widths (128, 256), one
    resnet a block, 16x16 images."""
    torch.manual_seed(0)
    vae = StableDiffusionVAE(block_out_channels=(128, 256), layers_per_block=1).eval()
    with torch.no_grad():
        for name, p in vae.named_parameters():
            if "norm" in name and name.endswith("weight"):
                p.copy_(0.5 + torch.rand_like(p))
    return vae


def _as_if_on_the_card(monkeypatch):
    """The route's rule with the CPU taken for the card: routed convs run
    ``conv_tf32x3``, which on the CPU is ``conv_tf32x3_plain``."""
    rule = fr.tf32x3_routes
    monkeypatch.setattr(fr, "tf32x3_routes", lambda dtype, device, *a: rule(dtype, "cuda", *a))


def test_routed_encoder_matches_the_plain_encoder(monkeypatch):
    vae = _small_vae()
    images = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.no_grad():
        want = vae.encode(images).mean
        plain = profiling.counters().get("vae.tf32x3_convs", 0)
        _as_if_on_the_card(monkeypatch)
        calls = []
        monkeypatch.setattr(fr, "conv_tf32x3_plain", lambda x, w, b, f=fr.conv_tf32x3_plain: calls.append(
            tuple(w.shape)) or f(x, w, b))
        before = profiling.counters().get("vae.tf32x3_convs", 0)
        got = vae.encode(images).mean
    assert plain == before  # the CPU encode routed nothing
    # down block 0's resnet, block 1's with its shortcut, the mid block's two
    assert profiling.counters()["vae.tf32x3_convs"] - before == len(calls) == 2 + 3 + 4
    assert (128, 128, 3, 3) in calls and (256, 128, 1, 1) in calls
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-5, err


def test_routed_decoder_matches_the_plain_decoder(monkeypatch):
    """The decoder's stride-1 convs route too (the same math; no cell runs it)."""
    vae = _small_vae()
    latent = torch.randn(1, 8, 8, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = vae.decode(latent)
        _as_if_on_the_card(monkeypatch)
        before = profiling.counters().get("vae.tf32x3_convs", 0)
        got = vae.decode(latent)
    # the mid block's 4, the up blocks' 2 x 2 resnets (one shortcut) and one upsampler conv
    assert profiling.counters()["vae.tf32x3_convs"] - before == 4 + 2 * 4 + 1 + 1
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-5, err


def test_routed_encoder_keeps_training_on_f_conv2d(monkeypatch):
    """With a gradient asked nothing routes, on the card or off it."""
    vae = _small_vae().requires_grad_(True)
    _as_if_on_the_card(monkeypatch)
    before = profiling.counters().get("vae.tf32x3_convs", 0)
    vae.encode(torch.zeros(1, 16, 16, 3)).mean.sum().backward()
    assert profiling.counters().get("vae.tf32x3_convs", 0) == before


@pytest.mark.parametrize("groups,routed", [(32, False), (16, True)])
def test_conv_after_a_norm_routes_where_the_pair_takes_the_norm(monkeypatch, groups, routed):
    """A routed conv behind a GroupNorm routes only where the channels-last
    pair takes that norm in float32 (whole 4-channel vectors a group): 64
    channels in 32 groups of 2 keep cuDNN and ``nn.GroupNorm``."""
    _as_if_on_the_card(monkeypatch)
    conv, x = nn.Conv2d(64, 128, 3, padding=1), torch.zeros(1, 64, 4, 4)
    with torch.no_grad():
        assert vae_module._routes(conv, x)
        assert vae_module._routes(conv, x, nn.GroupNorm(groups, 64)) is routed


@pytest.mark.parametrize("c_out,partials,tile", [
    (128, False, 128), (256, False, 128), (512, False, 128),  # the SD-VAE's widths fill 128-column tiles
    (128, True, 192), (256, True, 192), (512, True, 192),     # a launch with GroupNorm partials keeps 192
    (192, False, 192), (384, False, 192), (768, False, 192), (1536, False, 192),  # K3's widths: 192 fills them
    (96, False, 128), (8, False, 128),
])
def test_n_tile(c_out, partials, tile):
    assert fr.n_tile(TF32X3, c_out, partials) == tile
    assert fr.n_tile(fr.TENSOR_CORE_ROUTES[torch.bfloat16], c_out, partials) == fr.TILE_N  # one tile in bf16


@pytest.mark.parametrize("side,c_in,c_out,k", [(256, 128, 128, 3), (128, 256, 256, 3), (128, 128, 256, 1),
                                               (64, 512, 512, 3), (32, 512, 512, 3)])
def test_conv_plan_of_the_vae_encode(side, c_in, c_out, k):
    """The eval step's 64-image encode: M up to 64 x 65,536 rows fills the
    card many times over, so no stage splits K; a partial-free plan counts
    its waves in 128-column tiles, and the weight tile's hi and lo planes
    beside a tile's rows, so it takes 128-row tiles (each B tile serves
    twice the rows of a 64-row one)."""
    m = 64 * side * side
    k_slices = k * k * c_in // TF32X3.slice_k
    plan = fr.conv_plan(m, side * side, c_out, k_slices, 132, TF32X3)
    assert plan.splits == 1 and plan.bm == plan.tile == 128 and not plan.fused
    assert fr.conv_plan(m, side * side, c_out, k_slices, 132, TF32X3, groups=32).splits == 1
