"""The ADM pose U-Net (``nope_tpu_torch/models/adm_unet.py``) against the
benchmark's plain reference (``perfbench/reference/adm_unet.py``) on the
CPU at a small size, on one seeded state dict loaded strictly into both;
the published preset (``configs/model_adm.yaml``) against the benchmark's
configuration; the control's reach into the reference's attention; and
the ADM's spans and counters."""

import copy
import sys
from pathlib import Path

import pytest
import torch

from nope_tpu_torch.configs import load_config
from nope_tpu_torch.models.adm_unet import ADMAttentionBlock, ADMPoseUNet
from nope_tpu_torch.models.factory import _unet, init_weights
from nope_tpu_torch.models.ldm_unet import LDMPoseUNet
from nope_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness, inputs  # noqa: E402
from perfbench.reference import adm_unet as ref_adm  # noqa: E402
from perfbench.reference import lowp  # noqa: E402

SMALL = dict(model_channels=32, num_res_blocks=2, channel_mult=(1, 2, 2), attention_resolutions=(2, 4))
LATENT_HW = 16
CPU = torch.device("cpu")
#: float32: the same arithmetic in another order (a 1x1 conv1d against a
#: linear, channels-last convs) over ~30 layers moves outputs of order 1
#: by a few 1e-6 (at most 7.1e-6 over 48 seeded cases); 1e-4 leaves over
#: 10x of room, and a wrong head width moves them by 0.7 or more
F32_TOL = 1e-4
#: bfloat16: the program's widest gap from the float32 reference over the
#: reference's own bfloat16 gap; 0.61-1.36 over 48 seeded cases, held at
#: 3, under the benchmark's sim_ratio limits (3.2-3.8) for the same ratio
#: over a similarity row
BF16_RATIO = 3.0


def _pair(seed, head_channels=16, ref_head_channels=None, **flags):
    """(program, reference), the same seeded state dict in both."""
    args = dict(SMALL, num_head_channels=head_channels, **flags)
    ref_args = dict(args, num_head_channels=ref_head_channels or head_channels)
    with torch.device("meta"):
        prog_mods, ref_mods = {"unet": ADMPoseUNet(**args)}, {"unet": ref_adm.ADMPoseUNet(**ref_args)}
    state = inputs.seeded_state(ref_mods, seed, CPU)
    return inputs.load(prog_mods, state, CPU)["unet"], inputs.load(ref_mods, state, CPU, frozen=True)["unet"]


def _inputs(seed, b=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(b, 4, LATENT_HW, LATENT_HW, generator=gen), torch.randn(b, 6, generator=gen)


@pytest.mark.parametrize("head_channels", [16, 32])
@pytest.mark.parametrize("use_scale_shift_norm", [True, False], ids=["film", "add"])
@pytest.mark.parametrize("resblock_updown", [True, False], ids=["updown", "conv"])
def test_the_port_equals_the_reference_in_float32(head_channels, use_scale_shift_norm, resblock_updown):
    prog, want = _pair(11, head_channels, use_scale_shift_norm=use_scale_shift_norm,
                       resblock_updown=resblock_updown)
    x, pose = _inputs(1)
    with torch.no_grad():
        got, expected = prog(x, pose), want(x, pose)
    assert expected.abs().max() > 0.1  # every layer drawn: the output is not the skip alone
    torch.testing.assert_close(got, expected, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("head_channels", [16, 32])
def test_the_port_in_bfloat16_is_as_near_the_reference_as_the_reference_in_bfloat16(head_channels):
    prog, want = _pair(12, head_channels)
    x, pose = _inputs(2)
    with torch.no_grad():
        exact = want(x, pose)
        stated = copy.deepcopy(want).to(torch.bfloat16)(x.bfloat16(), pose.bfloat16()).float()
        got = prog.to(torch.bfloat16)(x.bfloat16(), pose.bfloat16()).float()
    own_gap = (stated - exact).abs().max()
    assert own_gap > 0
    assert (got - exact).abs().max() <= BF16_RATIO * own_gap


def test_a_wrong_head_width_fails_the_comparison():
    prog, want = _pair(13, head_channels=16, ref_head_channels=32)
    x, pose = _inputs(3)
    with torch.no_grad():
        got, expected = prog(x, pose), want(x, pose)
        stated = copy.deepcopy(want).to(torch.bfloat16)(x.bfloat16(), pose.bfloat16()).float()
    gap = (got - expected).abs().max()
    assert not torch.allclose(got, expected, rtol=F32_TOL, atol=F32_TOL)
    assert gap > BF16_RATIO * (stated - expected).abs().max()  # the bfloat16 test's bound fails it too


def _heads(module, kind):
    return sorted((m.norm.num_channels, m.num_heads) for m in module.modules() if isinstance(m, kind))


def test_the_preset_builds_the_benchmarks_module():
    model = load_config(str(ROOT / "configs" / "model_adm.yaml")).model
    cfg = harness.load_json(ROOT / "perfbench" / "configs" / "vae_guidedDiffusion.json")
    with torch.device("meta"):
        built = _unet(model.u_net, model.encoder.latent_dim)
    bench = inputs.meta_modules(cfg, "program")["unet"]
    reference = inputs.meta_modules(cfg, "reference")["unet"]
    assert type(built) is type(bench) is ADMPoseUNet
    shapes = {k: tuple(v.shape) for k, v in built.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in bench.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in reference.state_dict().items()}
    assert _heads(built, ADMAttentionBlock) == _heads(bench, ADMAttentionBlock) == _heads(
        reference, ref_adm.ADMAttentionBlock)
    assert set(_heads(built, ADMAttentionBlock)) == {(512, 8), (1024, 16)}
    assert sum(p.numel() for p in built.parameters()) == 551_506_180
    assert model.img_size == cfg["img_size"] and model.encoder.kind == "vae"
    assert model.encoder.latent_dim == cfg["unet"]["args"]["in_channels"]
    # UNetConfig's defaults give the LDM's 32-channel heads: twice the published count
    default = load_config(None, ["model.u_net.variant=vae_guidedDiffusion"]).model
    with torch.device("meta"):
        halved = _unet(default.u_net, default.encoder.latent_dim)
    assert set(_heads(halved, ADMAttentionBlock)) == {(512, 16), (1024, 32)}


def _attention_projections(module):
    return [m for block in module.modules() if isinstance(block, ref_adm.ADMAttentionBlock)
            for m in (block.qkv, block.proj_out)]


def test_the_controls_float8_reaches_the_references_attention_projections():
    _, want = _pair(14)
    low = lowp.fp8_copy(want)
    originals, copies = _attention_projections(want), _attention_projections(low)
    assert copies and len(copies) == len(originals)
    gen = torch.Generator().manual_seed(4)
    for orig, m in zip(originals, copies):
        assert m.weight.shape == orig.weight.shape and m.weight.dim() == 3
        assert torch.equal(m.weight, lowp.fp8_round(orig.weight.detach().to(torch.bfloat16)))
        x = torch.randn(2, m.in_features, 5, generator=gen).bfloat16()
        want_out = torch.nn.functional.linear(lowp.fp8_round(x).transpose(1, 2), m.weight[..., 0], m.bias)
        assert torch.equal(m(x), want_out.transpose(1, 2))


def test_the_controls_tf32_reaches_the_references_attention_projections(monkeypatch):
    _, want = _pair(15)
    block = next(m for m in want.modules() if isinstance(m, ref_adm.ADMAttentionBlock))
    c = block.norm.num_channels
    rounded = []
    tf32_round = lowp.tf32_round
    monkeypatch.setattr(lowp, "tf32_round", lambda t: rounded.append(tuple(t.shape)) or tf32_round(t))
    x = torch.randn(2, c, 4, 4, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        exact = block(x)
        with lowp.tf32():
            low = block(x)
    assert (3 * c, c) in rounded and (c, c) in rounded  # qkv's and proj_out's weights through F.linear
    assert not torch.equal(low, exact)


# -- spans and counters ---------------------------------------------------------------------------

PUBLISHED_STRUCTURE = dict(model_channels=32, num_res_blocks=2, channel_mult=(1, 1, 2, 2, 4, 4),
                           attention_resolutions=(32, 16, 8), num_head_channels=32)


@pytest.fixture(autouse=True)
def empty_store():
    profiling.spans(clear=True)
    yield
    profiling.spans(clear=True)


def _adm_counters():
    table = profiling.counters()
    return [table.get(f"adm.{name}", 0) for name in ("res_blocks", "resample_blocks", "attn_blocks")]


def test_an_adm_forward_records_its_spans_and_counts_its_blocks(tmp_path):
    unet = init_weights(ADMPoseUNet(**PUBLISHED_STRUCTURE), torch.Generator().manual_seed(6)).eval()
    x, pose = torch.randn(2, 4, 32, 32), torch.randn(2, 6)
    before = _adm_counters()
    with torch.no_grad():
        unet(x, pose)
    assert profiling.spans() == []  # off without a profiler; the counters are always on
    after_off = _adm_counters()
    assert [a - b for a, b in zip(after_off, before)] == [42, 10, 16]
    with profiling.trace(str(tmp_path)), torch.no_grad():
        unet(x, pose)
    assert [a - b for a, b in zip(_adm_counters(), after_off)] == [42, 10, 16]
    spans = profiling.spans()
    res = [s for s in spans if s["name"] == "adm.res"]
    attn = [s for s in spans if s["name"] == "adm.attn"]
    assert len(res) == 42 and len(attn) == 16 and len(spans) == 58
    for s in res + attn:
        assert s["attrs"]["items"] == 2 and s["attrs"]["dtype"] == "float32" and s["parent"] is None
    resample = [s["attrs"]["shape"][5] for s in res]
    assert resample.count("down") == 5 and resample.count("up") == 5 and resample.count("") == 32
    first = res[0]["attrs"]["shape"]
    assert first == (32, 32, 32, 32, True, "")
    down = next(s["attrs"]["shape"] for s in res if s["attrs"]["shape"][5] == "down")
    assert down == (32, 32, 32, 32, True, "down")  # read at the block's input, before it halves
    assert {s["attrs"]["shape"] for s in attn} == {(16, 64, 2), (4, 128, 4), (1, 128, 4)}


def test_an_ldm_forward_records_no_adm_span_and_counts_nothing(tmp_path):
    ldm = init_weights(LDMPoseUNet(model_channels=32, num_res_blocks=1, attention_resolutions=(2, 1),
                                   channel_mult=(1, 2), num_head_channels=16, context_dim=24),
                       torch.Generator().manual_seed(7)).eval()
    before = _adm_counters()
    with profiling.trace(str(tmp_path)), torch.no_grad():
        ldm(torch.randn(2, 4, 8, 8), torch.randn(2, 6))
    assert not [s for s in profiling.spans() if s["name"].startswith("adm.")]
    assert _adm_counters() == before
