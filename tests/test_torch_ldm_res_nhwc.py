"""The channels-last GroupNorm path on the CPU: the LDM's and the ADM's
res blocks (``LDMResBlock._forward_channels_last``) and
``fused_resnet.group_norm_film_silu_nhwc`` in bf16 and float32 (the
float32 SD-VAE's norms).

The CUDA kernel pair cannot run here: the wrapper's CPU branch (the same
table folding) is held against the block's plain ``nn.GroupNorm``
forward; the route predicate, the block's use of it and the block's
counter are checked; and the pair's launches (``fused_resnet._norm_kernels``)
run against an emulation of ``nope_gn_nhwc_stats`` / ``nope_gn_nhwc_apply``
on host memory that computes by the kernels' own steps, spans and merge
order, in either dtype.  On the card, ``chip_smoke.py`` phase 2 holds the
kernels.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from nope_tpu_torch.models.adm_unet import ADMPoseUNet
from nope_tpu_torch.models.ldm_unet import LDMPoseUNet, LDMResBlock
from nope_tpu_torch.ops import _build
from nope_tpu_torch.ops import fused_resnet as fr
from nope_tpu_torch.utils import profiling

CL = torch.channels_last


def _block(film: bool, resample: str, cin: int, co: int, dtype: torch.dtype, seed: int) -> LDMResBlock:
    """A res block with every parameter drawn (its zero conv too)."""
    torch.manual_seed(seed)
    blk = LDMResBlock(cin, 16, co, use_scale_shift_norm=film, up=resample == "up", down=resample == "down")
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0.0, 0.2)
    return blk.to(dtype)


def _inputs(cin: int, dtype: torch.dtype, seed: int, side: int = 8):
    gen = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(3, cin, side, side, generator=gen) + 0.5).to(dtype).contiguous(memory_format=CL)
    return x, torch.randn(3, 16, generator=gen).to(dtype)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# (FiLM or the embedding added before the norm, resample, Cin, Co, dtype):
# 32 groups of 2 and 3 channels (any width: the CPU branch)
BLOCKS = [(film, resample, cin, co, dtype) for film in (True, False) for resample in ("", "up", "down")
          for cin, co in ((64, 64), (64, 96)) for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("film,resample,cin,co,dtype", BLOCKS)
def test_channels_last_block_matches_the_plain_block(film, resample, cin, co, dtype):
    """The channels-last forward against the plain one: float32 within
    rounding; bf16 no further from the block's float32 forward than twice
    the plain bf16 forward's gap (the tables round once where the plain
    ops round after each).  Its output stays channels-last."""
    blk = _block(film, resample, cin, co, dtype, seed=cin + co + len(resample))
    x, emb = _inputs(cin, dtype, seed=co)
    with torch.no_grad():
        got = blk._forward_channels_last(x, emb)
        plain = blk(x, emb)
        want = blk.float()(x.float(), emb.float())
    assert got.dtype == dtype and got.shape == plain.shape and got.is_contiguous(memory_format=CL)
    if dtype == torch.float32:
        assert _rel(got, plain) <= 1e-5
    else:
        assert _rel(got, want) <= 2 * _rel(plain, want)


# (dtype, device type, grad, channels-last, the block's GroupNorm widths, groups, routed)
ROUTES = [
    (torch.bfloat16, "cuda", False, True, (256, 512), 32, True),
    (torch.bfloat16, "cuda", False, True, (2048, 1024), 32, True),   # the widest: 256 threads of 8 channels
    (torch.float32, "cuda", False, True, (256, 512), 32, False),     # the fp32 loss keeps the plain path
    (torch.bfloat16, "cuda", True, True, (256, 512), 32, False),     # refinement, training
    (torch.bfloat16, "cpu", False, True, (256, 512), 32, False),
    (torch.bfloat16, "cuda", False, False, (256, 512), 32, False),   # an NCHW input
    (torch.bfloat16, "cuda", False, True, (256, 96), 32, False),     # 3 channels a group: not 16-byte vectors
    (torch.bfloat16, "cuda", False, True, (4096, 512), 32, False),   # wider than a block spans
    (torch.bfloat16, "cuda", False, True, (256, 512), 64, False),    # more groups than warp 0's lanes
]


@pytest.mark.parametrize("dtype,device_type,grad,channels_last,widths,groups,routed", ROUTES)
def test_route_predicate(dtype, device_type, grad, channels_last, widths, groups, routed):
    assert fr.channels_last_norms_route(dtype, device_type, grad, channels_last, widths, groups) is routed


@pytest.mark.parametrize("mode", ["no_grad", "eval_copy_grad_mode", "grad_params", "grad_input", "nchw"])
def test_block_asks_the_route_what_it_sees(monkeypatch, mode):
    """The block passes the predicate its dtype, device, grad mode (on
    even where nothing asks a gradient: refinement's blocks before the
    pose enters keep the plain ops), its input's layout and both
    GroupNorms' widths."""
    asked = []

    def spy(*args):
        asked.append(args)
        return False

    monkeypatch.setattr(fr, "channels_last_norms_route", spy)
    blk = _block(True, "", 64, 96, torch.bfloat16, seed=1)
    x, emb = _inputs(64, torch.bfloat16, seed=2)
    if mode != "grad_params":
        blk.requires_grad_(False)
    if mode == "grad_input":
        emb.requires_grad_()
    if mode == "nchw":
        x = x.contiguous()
    with torch.no_grad() if mode in ("no_grad", "nchw") else contextlib.nullcontext():
        blk(x, emb)
    grad = mode not in ("no_grad", "nchw")
    assert asked == [(torch.bfloat16, "cpu", grad, mode != "nchw", (64, 96), 32)]


@pytest.mark.parametrize("dtype,grad,call", [(torch.bfloat16, False, "forward"), (torch.float32, False, "forward"),
                                             (torch.bfloat16, True, "forward"),
                                             (torch.bfloat16, False, "_forward_channels_last")])
def test_counter_stays_zero_off_the_card(dtype, grad, call):
    """``ldm_res.nhwc_norms`` and ``gn_nhwc.launches`` count only the
    kernel pair's GroupNorms: no CPU forward, fp32, grad mode or the CPU
    branch itself moves them."""
    blk = _block(False, "down", 64, 64, dtype, seed=3)
    x, emb = _inputs(64, dtype, seed=4)
    names = ("ldm_res.nhwc_norms", "gn_nhwc.launches")
    before = [profiling.counters().get(n, 0) for n in names]
    with contextlib.nullcontext() if grad else torch.no_grad():
        getattr(blk, call)(x, emb)
    assert [profiling.counters().get(n, 0) for n in names] == before


@pytest.mark.parametrize("shape,launched", [((2, 1, 1, 256), 1), ((2, 0, 4, 256), 0), ((0, 2, 2, 256), 0)])
def test_counter_counts_each_launch_of_the_pair(monkeypatch, shape, launched):
    """Past the CPU branch (a meta tensor stands in for the card's) a call
    launches the pair once (its two kernels, through the launcher) and
    counts it in ``gn_nhwc.launches``; an empty input launches and counts
    nothing.  No other counter moves: the count of a res block's
    GroupNorms on the route belongs to the block."""
    monkeypatch.setattr(_build, "check_cuda", lambda *args, **kwargs: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    calls = []

    @contextlib.contextmanager
    def launcher(device):
        yield lambda name, *args: calls.append(name)

    monkeypatch.setattr(_build, "launcher", launcher)
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    gamma, beta = torch.ones(256, device="meta"), torch.zeros(256, device="meta")
    before = profiling.counters()
    fr.group_norm_film_silu_nhwc(x, gamma, beta, 32, 1e-5)
    assert calls == ["nope_gn_nhwc_stats", "nope_gn_nhwc_apply"] * launched
    moved = {k: v - before.get(k, 0) for k, v in profiling.counters().items() if v != before.get(k, 0)}
    assert moved == ({"gn_nhwc.launches": 1} if launched else {})


def _tiny_adm():
    return ADMPoseUNet(model_channels=32, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                       num_head_channels=16)


def _tiny_ldm():
    return LDMPoseUNet(model_channels=32, num_res_blocks=1, attention_resolutions=(2, 1), channel_mult=(1, 2),
                       num_head_channels=16, context_dim=24)


@pytest.mark.parametrize("make", [_tiny_adm, _tiny_ldm])
def test_every_res_block_sees_a_channels_last_input(monkeypatch, make):
    """Through a whole bf16 forward (no gradient) of the ADM and of the
    LDM on the channels-last path, every res block's input is
    channels-last -- after the skips' concatenation, the attention blocks,
    the resamplers -- so on the card each takes the pair."""
    asked = []

    def spy(dtype, device_type, grad, channels_last, widths, groups):
        asked.append((dtype, device_type, grad, channels_last, widths, groups))
        return channels_last and not grad

    monkeypatch.setattr(fr, "channels_last_norms_route", spy)
    net = make().to(torch.bfloat16).requires_grad_(False)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        net(torch.randn(2, 4, 8, 8, generator=gen).to(torch.bfloat16),
            torch.randn(2, 6, generator=gen).to(torch.bfloat16))
    assert len(asked) == sum(isinstance(m, LDMResBlock) for m in net.modules()) > 0
    assert all(a[2] is False and a[3] is True for a in asked)


@pytest.mark.parametrize("make", ["adm", "ldm"])
@pytest.mark.parametrize("routed", [True, False])
def test_block_counts_its_two_norms_where_it_takes_the_route(monkeypatch, make, routed):
    """``ldm_res.nhwc_norms`` moves by two for each res block that takes
    the channels-last route, counted where the block takes it, through a
    whole tiny bf16 forward (the route answering as on the card), and not
    at all where the route says no."""
    monkeypatch.setattr(fr, "channels_last_norms_route", lambda *args: routed)
    net = (_tiny_adm if make == "adm" else _tiny_ldm)().to(torch.bfloat16).requires_grad_(False)
    gen = torch.Generator().manual_seed(7)
    before = profiling.counters().get("ldm_res.nhwc_norms", 0)
    with torch.no_grad():
        net(torch.randn(2, 4, 8, 8, generator=gen).to(torch.bfloat16),
            torch.randn(2, 6, generator=gen).to(torch.bfloat16))
    blocks = sum(isinstance(m, LDMResBlock) for m in net.modules())
    assert blocks > 0
    assert profiling.counters().get("ldm_res.nhwc_norms", 0) - before == (2 * blocks if routed else 0)


# (B, H, W, C, SMs): samples split into spans of whole steps (several
# steps a span where the batch fills the SMs halfway), a ragged last span,
# 8, 16 and 24 channels a group (192 threads at 768 in bf16), the widest
# block (2048 bf16 channels: one pixel a step; 1024 float32), 1x1 samples
PLANS = [(3, 32, 32, 256, 132), (8, 16, 16, 256, 1), (2, 16, 16, 512, 132), (3, 12, 12, 256, 2),
         (5, 8, 8, 256, 1), (3, 4, 4, 768, 132), (2, 2, 2, 2048, 132), (4, 1, 1, 1024, 132)]
# the plans each dtype's pair takes at 32 groups (float32: C % 128 == 0, C <= 1024)
DTYPE_PLANS = [(dtype, *plan) for dtype in (torch.bfloat16, torch.float32) for plan in PLANS
               if fr.nhwc_norm_fits(dtype, plan[3], 32)]


@pytest.mark.parametrize("dtype,batch,h,w,c,sms", DTYPE_PLANS + [
    (torch.bfloat16, 1984, 32, 32, 256, 132), (torch.bfloat16, 65_600, 1, 1, 1024, 132),
    (torch.float32, 64, 256, 256, 128, 132), (torch.float32, 64, 32, 32, 512, 132)])
def test_norm_plan_covers_each_sample_once(dtype, batch, h, w, c, sms):
    vec = fr.norm_vec(dtype)
    span, splits = fr.norm_plan(batch, h * w, c, sms, vec)
    step = max(1, fr.NORM_THREADS // (c // vec)) * fr.NORM_ROWS
    assert span % step == 0 and span * (splits - 1) < h * w <= span * splits
    assert splits == 1 or batch * (splits - 1) < fr.NORM_BLOCKS_PER_SM * sms


# (dtype, C, groups, taken): whole 16-byte vectors a group, one block across a pixel, at most 32 groups
FITS = [(torch.bfloat16, 256, 32, True), (torch.bfloat16, 2048, 32, True), (torch.bfloat16, 96, 32, False),
        (torch.bfloat16, 4096, 32, False), (torch.float32, 128, 32, True), (torch.float32, 1024, 32, True),
        (torch.float32, 64, 32, False), (torch.float32, 2048, 32, False), (torch.float32, 256, 64, False),
        (torch.float32, 64, 16, True)]


@pytest.mark.parametrize("dtype,c,groups,taken", FITS)
def test_width_rule_of_each_dtype(dtype, c, groups, taken):
    assert fr.nhwc_norm_fits(dtype, c, groups) is taken


def _view(ptr, n, dt):
    """n elements of dtype code dt at host address ptr, as a torch view."""
    if dt == 0:
        return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr)))
    raw = np.ctypeslib.as_array((ctypes.c_int16 * n).from_address(ptr))
    return torch.from_numpy(raw).view(torch.bfloat16)


def _chan_merge(n, mu, m2, nb, mb, qb):
    nt = n + nb
    d = mb - mu
    return nt, mu + d * (nb / nt), m2 + qb + d * d * (n * nb / nt)


class _EmulatedNorms:
    """``nope_gn_nhwc_stats`` and ``nope_gn_nhwc_apply`` on host memory:
    the C entry points' checks, each block's steps of ny·8 pixels (a
    step's group mean, then its squared deviations, merged into the span's
    partial by Chan's formula), the apply's merge of a sample's partials
    in span order and its tables, in float64."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, *args):
        self.calls.append((name, args))
        getattr(self, name)(*args)

    @staticmethod
    def _shape(xdt, b, hw, c, groups, span, splits, grid_y):
        vec = 4 if xdt == 0 else 8  # channels of a thread's 16-byte vector
        assert xdt in (0, 1) and 1 <= groups <= 32 and c % (vec * groups) == 0 and c // vec <= fr.NORM_THREADS
        assert span >= 1 and span * (splits - 1) < hw <= span * splits and 1 <= grid_y <= _build.MAX_GRID_Y
        return max(1, fr.NORM_THREADS // (c // vec)) * fr.NORM_ROWS

    def nope_gn_nhwc_stats(self, x, xdt, addend, adt, part, b, hw, c, groups, span, splits, grid_y):
        step = self._shape(xdt, b, hw, c, groups, span, splits, grid_y)
        v = _view(x, b * hw * c, xdt).double().reshape(b, hw, c)
        if addend is not None:
            v = v + _view(addend, b * c, adt).double().reshape(b, 1, c)
        out = _view(part, b * splits * groups * 3, 0).reshape(b, splits, groups, 3)
        cg = c // groups
        for k in range(splits):
            p0, p1 = k * span, min(hw, (k + 1) * span)
            for i in range(b):
                for g in range(groups):
                    n = mu = m2 = 0.0
                    for t0 in range(p0, p1, step):
                        tile = v[i, t0:min(t0 + step, p1), g * cg:(g + 1) * cg]
                        mean = tile.sum().item() / tile.numel()
                        n, mu, m2 = _chan_merge(n, mu, m2, tile.numel(), mean, ((tile - mean) ** 2).sum().item())
                    out[i, k, g] = torch.tensor([n, mu, m2])

    def nope_gn_nhwc_apply(self, x, xdt, part, gamma, beta, pdt, addend, adt, film, fdt, out, b, hw, c, groups,
                           span, splits, grid_y, eps):
        self._shape(xdt, b, hw, c, groups, span, splits, grid_y)
        parts = _view(part, b * splits * groups * 3, 0).double().reshape(b, splits, groups, 3)
        mean, rstd = torch.empty(b, groups, dtype=torch.float64), torch.empty(b, groups, dtype=torch.float64)
        for i in range(b):
            for g in range(groups):
                n = mu = m2 = 0.0
                for k in range(splits):
                    n, mu, m2 = _chan_merge(n, mu, m2, *parts[i, k, g].tolist())
                mean[i, g], rstd[i, g] = mu, 1.0 / np.sqrt(m2 / n + eps)
        m, a, d = fr.norm_tables(mean, rstd, _view(gamma, c, pdt).double(), _view(beta, c, pdt).double(),
                              None if addend is None else _view(addend, b * c, adt).double().reshape(b, c),
                              None if film is None else _view(film, b * 2 * c, fdt).double().reshape(b, 2 * c))
        v = _view(x, b * hw * c, xdt).double().reshape(b, hw, c)
        _view(out, b * hw * c, xdt).copy_(torch.nn.functional.silu((v - m[:, None]) * a[:, None] + d[:, None]).reshape(-1))


# a bf16 output within one rounding of the CPU branch; a float32 one within a few
TOLERANCE = {torch.bfloat16: 2 ** -7, torch.float32: 1e-6}


@pytest.mark.parametrize("cond", ["film", "addend", "plain", "addend+film"])
@pytest.mark.parametrize("dtype,batch,h,w,c,sms", DTYPE_PLANS)
def test_pair_launches_equal_the_cpu_branch(monkeypatch, dtype, batch, h, w, c, sms, cond):
    """``_norm_kernels`` against the emulated kernels: the plan's spans
    (samples split over blocks, ragged last spans), x's dtype code, the
    partials' layout and merge, the FiLM's [scale | shift] and the addend
    reach the output as the CPU branch computes it (within one rounding
    of a bf16 output; float32 within a few of its own)."""
    emulated = _EmulatedNorms()

    @contextlib.contextmanager
    def launcher(device):
        yield emulated

    monkeypatch.setattr(_build, "launcher", launcher)
    monkeypatch.setattr(_build, "sm_count", lambda device: sms)
    gen = torch.Generator().manual_seed(batch * c + h)
    x = (2 * torch.randn(batch, h, w, c, generator=gen) + 0.5).to(dtype)
    gamma = (1 + 0.2 * torch.randn(c, generator=gen)).to(dtype)
    beta = (0.2 * torch.randn(c, generator=gen)).to(dtype)
    addend = (0.5 * torch.randn(batch, c, generator=gen)).to(dtype) if "addend" in cond else None
    film = (0.5 * torch.randn(batch, 2 * c, generator=gen)).to(dtype) if "film" in cond else None
    out = torch.empty_like(x)
    fr._norm_kernels(x, gamma, beta, 32, 1e-5, addend, film, out)
    assert [name for name, _ in emulated.calls] == ["nope_gn_nhwc_stats", "nope_gn_nhwc_apply"]
    assert all(args[1] == _build.DTYPE_CODES[dtype] for _, args in emulated.calls)
    span, splits = fr.norm_plan(batch, h * w, c, sms, fr.norm_vec(dtype))
    assert emulated.calls[0][1][-3:] == (span, splits, _build.grid_y(batch))
    want = fr.group_norm_film_silu_nhwc(x, gamma, beta, 32, 1e-5, addend=addend, film=film)
    assert (out.float() - want.float()).abs().max() <= TOLERANCE[dtype] * want.float().abs().max()


def test_pair_strides_samples_past_the_grid(monkeypatch):
    """Past the grid's y extent the launches pass the capped extent (each
    block then strides over samples)."""
    monkeypatch.setattr(_build, "MAX_GRID_Y", 3)
    emulated = _EmulatedNorms()

    @contextlib.contextmanager
    def launcher(device):
        yield emulated

    monkeypatch.setattr(_build, "launcher", launcher)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(7, 1, 1, 256, generator=gen).to(torch.bfloat16)
    gamma, beta = torch.ones(256, dtype=torch.bfloat16), torch.zeros(256, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    fr._norm_kernels(x, gamma, beta, 32, 1e-5, None, None, out)
    assert all(args[-2 if name.endswith("apply") else -1] == 3 for name, args in emulated.calls)
    want = fr.group_norm_film_silu_nhwc(x, gamma, beta, 32, 1e-5)
    assert (out.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()


@pytest.mark.parametrize("cond", ["plain", "addend", "film", "addend+film"])
def test_card_check_draws_and_holds_each_conditioning(cond):
    """``chip_smoke.py``'s phase-2 check of the pair, on the CPU: the
    spy's label of a call, the inputs it draws for that label and its
    float32 ``F.group_norm`` reference agree with the wrapper's CPU
    branch on the same inputs."""
    import chip_smoke

    gen = torch.Generator().manual_seed(6)
    x, gamma, beta, addend, film = chip_smoke.nhwc_norm_inputs(torch, (4, 4, 256), 3, cond, "cpu", gen)
    assert chip_smoke.nhwc_norm_cond(addend, film) == cond
    assert (addend is None or addend.shape == (3, 256)) and (film is None or film.shape == (3, 512))
    want = chip_smoke.nhwc_norm_plain(torch, torch.nn.functional, x, gamma, beta, addend, film)
    got = fr.group_norm_film_silu_nhwc(x, gamma, beta, 32, 1e-5, addend=addend, film=film)
    assert _rel(got, want) <= chip_smoke.TOL["bfloat16"]["GN"]
