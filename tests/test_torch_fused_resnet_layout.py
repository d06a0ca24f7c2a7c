"""K3's bf16 tensor-core route, in plain torch on the CPU: the packed
weight layout the conv reads, the per-tile GroupNorm partials and their
Chan merge against the JAX package's GroupNorm, the tiling plan, and the
wrapper's launches (pointers, offsets, split-K, statistics) run against
an emulation of the C entry points on host memory."""

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

torch.set_num_threads(1)


def im2col(x: torch.Tensor, ks: int) -> torch.Tensor:
    """(B, H, W, Cin) → (B·H·W, ks·ks·Cin), K ordered (tap, ci), zero halo."""
    b, h, w, c = x.shape
    p = ks // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    cols = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(ks) for dx in range(ks)]
    return torch.cat(cols, dim=-1).reshape(b * h * w, ks * ks * c)


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
# tiles are those of fr.TILE_M
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


@pytest.mark.parametrize("m,hw,co,k_slices,want", [
    (26 * 1024, 1024, 192, 27, (64, 1, 2)),    # 32x32 at B=26: 416 tiles of 64 rows in 2 waves, not 139 of 192
    (341 * 1024, 1024, 192, 27, (192, 1, 2)),  # 32x32 at B=341: as many waves, fewer bytes
    (26 * 256, 256, 192, 27, (64, 2, 2)),      # 16x16 at B=26: 104 tiles, K split in two
    (26 * 16, 16, 768, 108, (64, 9, 5)),       # 4x4 at B=26: 28 tiles
    (341 * 16, 16, 768, 108, (192, 1, 13)),    # 4x4 at B=341: one wave of 116 tiles, not two
    (3 * 16, 16, 768, 6, (64, 1, 5)),          # too few K-slices to split
])
def test_conv_plan(m, hw, co, k_slices, want):
    assert tuple(fr.conv_plan(m, hw, co, k_slices, 132)) == want


# -- the wrapper's launches against an emulation of the C entry points --------

def _view(ptr, n, dt):
    """n elements of dtype code dt at host address ptr, as a torch view."""
    if dt == 0:
        return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr)))
    raw = np.ctypeslib.as_array((ctypes.c_int16 * n).from_address(ptr))
    return torch.from_numpy(raw).view(torch.bfloat16)


def _store(ptr, n, dt, value):
    _view(ptr, n, dt).copy_(value.reshape(-1).to(torch.float32 if dt == 0 else torch.bfloat16))


class _EmulatedKernels:
    """The C entry points of csrc/fused_resnet.cu on host memory, by what
    each kernel computes (in float64), with the kernels' own tiling."""

    def __init__(self):
        self.calls = []
        self.tiles = set()  # the bm of every tensor-core conv

    def __call__(self, name, *args):
        self.calls.append(name)
        getattr(self, name)(*args)

    @staticmethod
    def _conv(x, w_kco, ks):
        return im2col(x.double(), ks) @ w_kco.double()

    def nope_conv_wgmma(self, x, w, bias, bdt, out, part, ws, b, h, wd, cin, co, ks, groups, bm, splits,
                        segmax):
        m, k = b * h * wd, ks * ks * cin
        self.tiles.add(bm)
        xs = _view(x, m * cin, 1).reshape(b, h, wd, cin)
        wt = _view(w, co * k, 1).reshape(co, k)
        cols = im2col(xs.double(), ks)
        kt = k // 64
        acc = torch.zeros(m, co, dtype=torch.float64)
        for s in range(splits):  # the split ranges of the kernel, summed in order
            lo, hi = 64 * (s * kt // splits), 64 * ((s + 1) * kt // splits)
            if splits > 1:
                _store(ws + 4 * s * m * co, m * co, 0, cols[:, lo:hi] @ wt[:, lo:hi].double().t())
            acc += cols[:, lo:hi] @ wt[:, lo:hi].double().t()
        res = (acc + _view(bias, co, bdt).double()).float()
        _store(out, m * co, 0, res)
        if part is not None:
            p = fr.gn_partials_plain(res, h * wd, groups, bm)
            assert p.shape[2] == segmax
            _store(part, p.numel(), 0, p)

    def nope_gn_finalize(self, part, gamma, pdt, mean, scale, b, hw, c, groups, bm, segmax, eps):
        n = -(-b * hw // bm) * groups * segmax * 3
        p = _view(part, n, 0).reshape(-1, groups, segmax, 3).clone()
        mu, rstd = fr.gn_merge_plain(p, b, hw, bm, eps)
        cg = c // groups
        _store(mean, b * c, 0, mu.reshape(b, groups).repeat_interleave(cg, 1))
        _store(scale, b * c, 0, rstd.reshape(b, groups).repeat_interleave(cg, 1) * _view(gamma, c, pdt).float())

    def nope_group_stats(self, hp, gamma, pdt, mean, scale, b, hw, c, groups, eps):
        hg = _view(hp, b * hw * c, 0).reshape(b, hw, groups, c // groups).double()
        mu, var = hg.mean((1, 3)), hg.var((1, 3), unbiased=False)
        cg = c // groups
        _store(mean, b * c, 0, mu.repeat_interleave(cg, 1))
        _store(scale, b * c, 0, (var + eps).rsqrt().repeat_interleave(cg, 1) * _view(gamma, c, pdt).double())

    def nope_gn_silu(self, hp, mean, scale, beta, pdt, emb, edt, res, rdt, out, odt, b, hw, c):
        hh = _view(hp, b * hw * c, 0).reshape(b, hw, c).double()
        y = (hh - _view(mean, b * c, 0).reshape(b, 1, c)) * _view(scale, b * c, 0).reshape(b, 1, c)
        y = F.silu(y + _view(beta, c, pdt).double())
        if emb is not None:
            y = y + _view(emb, b * c, edt).reshape(b, 1, c).double()
        if res is not None:
            y = y + _view(res, b * hw * c, rdt).reshape(b, hw, c).double()
        _store(out, b * hw * c, odt, y)

    def nope_conv_nhwc(self, x, w, bias, out, b, h, wd, cin, co, ks, xdt, wdt):
        xs = _view(x, b * h * wd * cin, xdt).reshape(b, h, wd, cin)
        wt = _view(w, ks * ks * cin * co, wdt).reshape(-1, co)
        _store(out, b * h * wd * co, 0, self._conv(xs, wt, ks) + _view(bias, co, wdt).double())


@pytest.mark.parametrize("route,batch,hw_side,cin,co,with_res,with_emb,sms", [
    ("tensor_cores", 3, 4, 128, 192, True, True, 132),   # ragged M; 64-row tiles over 4 samples, split K
    ("tensor_cores", 2, 8, 192, 192, False, False, 132),
    ("tensor_cores", 6, 8, 64, 384, True, False, 2),     # 192-row tiles cutting samples (2 SMs)
    ("tensor_cores", 15, 4, 192, 192, False, True, 1),   # 64-row tiles, ragged (1 SM)
    ("tensor_cores", 35, 4, 192, 192, False, True, 1),   # 192-row tiles of 12 samples, ragged (1 SM)
    ("cuda_cores", 2, 4, 16, 24, True, True, 132),
    ("cuda_cores", 2, 4, 24, 24, False, False, 132),
])
def test_block_launches_match_the_plain_block(monkeypatch, route, batch, hw_side, cin, co, with_res,
                                               with_emb, sms):
    emulated = _EmulatedKernels()

    @contextlib.contextmanager
    def launcher(device):
        yield emulated

    monkeypatch.setattr(_build, "launcher", launcher)
    monkeypatch.setattr(_build, "sm_count", lambda device: sms)
    gen = torch.Generator().manual_seed(batch * co + cin)
    dtype = torch.bfloat16 if route == "tensor_cores" else torch.float32
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
    before = fr.resnet_block.tensor_core_launches
    getattr(fr, f"_block_{route}")(x, emb, p, 8, 1e-5, out)
    want = fr.resnet_block_plain(x.float(), None if emb is None else emb.float(),
                                 {k: v.float() for k, v in p.items()})
    # bf16: act and the output are rounded to bf16 (the chip's tolerance);
    # float32: the emulation sums in float64
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    err = (out.float() - want).abs().max() / want.abs().max()
    assert err <= tol, err
    if route == "tensor_cores":
        assert emulated.calls.count("nope_conv_wgmma") == 2 + with_res
        assert emulated.tiles == {fr.conv_plan(batch * hw_side ** 2, hw_side ** 2, co, 9 * cin // 64, sms).bm}
        assert fr.resnet_block.tensor_core_launches == before + 1
    else:
        assert emulated.calls.count("nope_conv_nhwc") == 2 + with_res
