"""K1 port: nope_tpu_torch.ops.similarity against the JAX plain function
and the Pallas kernel in interpret mode, plus retrieval and dispatch; the
kernel's pixel-split partial sums, its tile plan, and the wrapper's
launch run against an emulation of the C entry point on host memory."""

import contextlib
import ctypes

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nope_tpu.ops import similarity as jsim
from nope_tpu.ops.experimental import pallas_similarity
from nope_tpu_torch.ops import _build
from nope_tpu_torch.ops import similarity as sim
from nope_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _data(seed=0, b=3, n=20, h=8, w=8, c=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, w, c)).astype(np.float32)
    t = rng.normal(size=(b, n, h, w, c)).astype(np.float32)
    return q, t


def test_plain_matches_jax_and_pallas_interpret():
    q, t = _data()
    got = sim.reference_similarity(torch.from_numpy(q), torch.from_numpy(t)).numpy()
    want = np.asarray(jsim.reference_similarity(jnp.asarray(q), jnp.asarray(t)))
    kernel = np.asarray(
        pallas_similarity.reference_similarity_pallas(jnp.asarray(q), jnp.asarray(t), interpret=True)
    )
    assert got.dtype == np.float32 and got.shape == (3, 20)
    # float32 sums over 64 pixels in another order: the repo's K1 tolerance
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-4)


def test_bank_with_leading_dim_one_broadcasts():
    q, t = _data(b=4)
    one = torch.from_numpy(t[:1])
    got = sim.reference_similarity(torch.from_numpy(q), one).numpy()
    want = np.asarray(jsim.reference_similarity(
        jnp.asarray(q), jnp.broadcast_to(jnp.asarray(t[:1]), t.shape)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="leading dim"):
        sim.reference_similarity(torch.from_numpy(q), torch.from_numpy(t[:2]))


def test_bf16_plain_computes_in_float32():
    q, t = _data()
    qb, tb = torch.from_numpy(q).bfloat16(), torch.from_numpy(t).bfloat16()
    got = sim.reference_similarity(qb, tb)
    assert got.dtype == torch.float32
    want = sim.reference_similarity(qb.float(), tb.float())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("metric", ["l2", "l2_true", "cosine"])
def test_retrieve_matches_jax(metric):
    q, t = _data(seed=1)
    s_t, i_t = sim.retrieve(torch.from_numpy(q), torch.from_numpy(t), k=5, metric=metric)
    with jax.default_matmul_precision("highest"):
        s_j, i_j = jsim.retrieve(jnp.asarray(q), jnp.asarray(t), k=5, metric=metric)
    # l2_true expands ‖q-t‖² (cancellation at |q|²~256): relative 1e-5
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


def test_cpu_call_does_not_count_a_launch():
    q, t = _data()
    before = profiling.counters().get("k1.launches", 0)
    sim.reference_similarity(torch.from_numpy(q), torch.from_numpy(t))
    assert profiling.counters().get("k1.launches", 0) == before


# -- K1's tiled, pixel-split kernel, in plain torch ----------------------------

def _split_data(b, n, lead, seed=3, side=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, side, side, 4)).astype(np.float32)
    t = rng.normal(size=(lead, n, side, side, 4)).astype(np.float32)
    return q, t


# B and N that are not multiples of the tile's 8 queries and 32 templates;
# banks with leading dim 1 and B; splits of 64 pixels, 96 (a ragged last
# split) and all 256
@pytest.mark.parametrize("b,n,lead,pixels", [(3, 20, 1, 64), (9, 37, 1, 96), (4, 33, 4, 64), (9, 37, 9, 256)])
def test_split_partials_match_jax_and_pallas_interpret(b, n, lead, pixels):
    q, t = _split_data(b, n, lead)
    parts = sim.similarity_partials_plain(torch.from_numpy(q), torch.from_numpy(t), pixels)
    assert parts.shape == (-(-256 // pixels), b, n)
    got = -parts.sum(0).numpy()
    full = np.broadcast_to(t, (b, *t.shape[1:]))
    want = np.asarray(jsim.reference_similarity(jnp.asarray(q), jnp.asarray(full)))
    kernel = np.asarray(pallas_similarity.reference_similarity_pallas(jnp.asarray(q), jnp.asarray(full),
                                                                      interpret=True))
    # float32 sums over 256 pixels in another order: the repo's K1 tolerance
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("args,want", [
    ((64, 341, 1024, False, 132), (64, 16)),   # 88 tiles: one 64-pixel step a block
    ((8, 26, 1024, True, 132), (64, 16)),      # a bank per query: one query a tile
    ((341, 341, 1024, False, 132), (256, 4)),  # 473 tiles: four splits of four steps
    ((341, 341, 1024, True, 132), (1024, 1)),  # 3751 one-query tiles: no split
    ((341, 341, 1024, False, 1), (1024, 1)),   # tiles enough: no split
    ((5, 7, 100, False, 132), (64, 2)),        # a ragged last step
])
def test_similarity_plan(args, want):
    plan = sim.similarity_plan(*args)
    assert (plan.pixels, plan.splits) == want and plan.step == sim.PIXEL_STEP
    assert plan.pixels % sim.PIXEL_STEP == 0 and (plan.splits - 1) * plan.pixels < args[2] <= plan.splits * plan.pixels


def _view(ptr, n, dt):
    if dt == 0:
        return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr)))
    return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_int16 * n).from_address(ptr))).view(torch.bfloat16)


class _EmulatedKernel:
    """``nope_reference_similarity`` on host memory.  The tiled route,
    block by block: each (template tile, query tile, pixel split) sums its
    pairs over its pixels, ragged queries and templates masked, after the
    entry point's checks (C % 4 == 0, C <= 128, 16-byte alignment, splits
    in whole steps); the scalar route, pair by pair over each split.
    Splits summed in order."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, q, bank, out, ws, b, n, s, c, batched, step, pixels, splits, grid_y, dt):
        assert name == "nope_reference_similarity"
        assert (ws is None) == (splits == 1) and splits == -(-s // pixels)
        tq = 1 if batched else sim.TILE_Q
        q_tiles = -(-b // tq)
        assert grid_y == _build.grid_y(q_tiles)
        self.calls.append((q, bank, out, ws, b, n, s, c, batched, step, pixels, splits, grid_y))
        size = 4 if dt == 0 else 2
        if step:
            assert c % 4 == 0 and c // 4 <= sim.MAX_VECS and step == sim.pixel_step(c, size)
            assert q % 16 == 0 and bank % 16 == 0 and (s * c * size) % 16 == 0
            assert pixels % step == 0
        qs = _view(q, b * s * c, dt).reshape(b, s, c).float()
        ts = _view(bank, (b if batched else 1) * n * s * c, dt).reshape(-1, n, s, c).float()
        part = torch.zeros(splits, b, n)
        # block y walks the query tiles y, y + grid_y, ...
        tiles = [t for y in range(grid_y) for t in range(y, q_tiles, grid_y)]
        assert sorted(tiles) == list(range(q_tiles))
        for z in range(splits):
            if not step:  # a thread per pair
                tb = ts[:, :, z * pixels:(z + 1) * pixels].expand(b, -1, -1, -1)
                d2 = torch.square(qs[:, None, z * pixels:(z + 1) * pixels] - tb)
                part[z] = torch.sqrt(torch.square(d2).sum(-1)).sum(-1)
                continue
            for b0 in (t * tq for t in tiles):
                for n0 in range(0, n, sim.TILE_N):
                    qb = qs[b0:b0 + tq, None, z * pixels:(z + 1) * pixels]
                    tb = (ts[b0:b0 + tq] if batched else ts[:1])[:, n0:n0 + sim.TILE_N, z * pixels:(z + 1) * pixels]
                    d2 = torch.square(qb - tb)
                    part[z, b0:b0 + tq, n0:n0 + sim.TILE_N] = torch.sqrt(torch.square(d2).sum(-1)).sum(-1)
        if splits > 1:
            _view(ws, splits * b * n, 0).copy_(part.reshape(-1))
        _view(out, b * n, 0).copy_(-part.sum(0).reshape(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,lead,sms", [(3, 41, 1, 132), (9, 20, 9, 132), (10, 40, 1, 1)])
def test_launch_matches_the_plain_version(monkeypatch, dtype, b, n, lead, sms):
    emulated = _EmulatedKernel()

    @contextlib.contextmanager
    def launcher(device):
        yield emulated

    monkeypatch.setattr(_build, "launcher", launcher)
    q, t = _split_data(b, n, lead, seed=b + n)
    qt, tt = torch.from_numpy(q).to(dtype), torch.from_numpy(t).to(dtype)
    plan = sim.similarity_plan(b, n, 256, lead == b and b > 1, sms)
    out = torch.empty(b, n)
    sim._launch(qt, tt, out, plan)
    want = sim.reference_similarity_plain(qt.float(), tt.float())
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
    (call,) = emulated.calls
    assert call[:3] == (qt.data_ptr(), tt.data_ptr(), out.data_ptr())
    tiles = b if lead == b and b > 1 else -(-b // sim.TILE_Q)
    assert call[4:] == (b, n, 256, 4, int(lead == b and b > 1), sim.PIXEL_STEP, plan.pixels, plan.splits,
                        _build.grid_y(tiles))


@pytest.mark.parametrize("b,lead,max_grid_y", [(9, 9, 2), (9, 9, 4), (20, 1, 2), (7, 7, 1)])
def test_launch_strides_past_the_grid_limit(monkeypatch, b, lead, max_grid_y):
    """With the grid's y extent capped below the query tiles (a bank per
    query: one query a tile), each block walks several tiles."""
    monkeypatch.setattr(_build, "MAX_GRID_Y", max_grid_y)
    emulated = _EmulatedKernel()

    @contextlib.contextmanager
    def launcher(device):
        yield emulated

    monkeypatch.setattr(_build, "launcher", launcher)
    q, t = _split_data(b, 1, lead, seed=b)
    qt, tt = torch.from_numpy(q), torch.from_numpy(t)
    out = torch.empty(b, 1)
    sim._launch(qt, tt, out, sim.similarity_plan(b, 1, 256, lead == b, 132))
    torch.testing.assert_close(out, sim.reference_similarity_plain(qt, tt), rtol=1e-5, atol=1e-4)
    assert emulated.calls[0][-1] == max_grid_y


@pytest.mark.parametrize("tiles,want", [(0, 1), (1, 1), (3, 3), (65535, 65535), (65536, 65535), (10**6, 65535)])
def test_grid_y(tiles, want):
    """The y extent of a launch: one block a tile up to CUDA's 65,535,
    beyond which the blocks stride; every tile is walked once."""
    got = _build.grid_y(tiles)
    assert got == want
    walked = np.concatenate([np.arange(y, tiles, got) for y in range(got)]) if tiles else np.zeros(0)
    assert len(walked) == tiles and len(np.unique(walked)) == tiles


@pytest.mark.parametrize("n", [8, 26, 341])
def test_top_k_orders_ties_as_jax(n):
    """Planted equal scores: ``retrieve`` lists them lower index first, as
    ``jax.lax.top_k`` does (``torch.topk`` leaves the order of ties open)."""
    rng = np.random.default_rng(n)
    scores = rng.normal(size=(5, n)).astype(np.float32)
    scores[0, [n - 1, 2, n // 2]] = 10.0  # a three-way tie for the best
    scores[1, :] = 0.5  # every score equal
    scores[2, [n - 1, 0]] = 3.0
    scores[2, [n - 2, 1]] = 2.0  # two ties inside the top-5
    scores[3, rng.choice(n, 7, replace=False)] = 7.0  # more tied than k
    scores[4, [n - 1, n - 3, n - 5, 4, 1]] = -20.0  # ties at the bottom
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores), 5)[1])
    got = sim.top_k(torch.from_numpy(scores), 5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], np.arange(5))
    # through retrieve, whose scores come from K1's plain version
    q = torch.zeros(2, 2, 2, 4)
    bank = torch.ones(1, n, 2, 2, 4)
    bank[0, [n - 1, 3]] = 0.0  # two exact matches
    _, idx = sim.retrieve(q, bank, k=5)
    np.testing.assert_array_equal(idx.numpy(), [[3, n - 1, 0, 1, 2]] * 2)


# -- any channel count ------------------------------------------------------------

@pytest.mark.parametrize("c", [3, 8])
@pytest.mark.parametrize("lead", [1, 3])
def test_plain_any_channel_count_matches_jax_and_pallas_interpret(c, lead):
    """K1's plain version at C = 3 and 8 (the template encoder's
    descriptors) against the JAX package's function and the Pallas kernel,
    which reduce over any C."""
    rng = np.random.default_rng(c + lead)
    q = rng.normal(size=(3, 8, 8, c)).astype(np.float32)
    t = rng.normal(size=(lead, 20, 8, 8, c)).astype(np.float32)
    got = sim.reference_similarity(torch.from_numpy(q), torch.from_numpy(t)).numpy()
    full = jnp.broadcast_to(jnp.asarray(t), (3, *t.shape[1:]))
    want = np.asarray(jsim.reference_similarity(jnp.asarray(q), full))
    kernel = np.asarray(pallas_similarity.reference_similarity_pallas(jnp.asarray(q), full, interpret=True))
    assert got.shape == (3, 20)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("c,size,want", [(4, 4, 64), (4, 2, 64), (8, 2, 32), (8, 4, 32), (12, 4, 21), (12, 2, 20),
                                         (20, 2, 12), (128, 2, 2)])
def test_pixel_step(c, size, want):
    """A step of the tiled kernel stays within C = 4's 64 vectors and, in
    bf16, whole 16-byte chunks."""
    got = sim.pixel_step(c, size)
    assert got == want and got * c // 4 <= sim.PIXEL_STEP and (got * c * size) % 16 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,lead,side,c,vector", [
    (9, 37, 1, 16, 8, True),     # the template encoder's C = 8, a shared bank
    (4, 33, 4, 16, 8, True),     # C = 8, a bank per query
    (9, 37, 1, 16, 12, True),    # an odd number of vectors a pixel
    (5, 20, 1, 16, 3, False),    # an odd C: the scalar kernel
    (3, 20, 3, 5, 3, False),     # odd C, odd pixel count, a bank per query
    (9, 37, 1, 5, 4, None),      # C = 4 with 25 pixels: fp32 tiled, bf16 scalar
    (4, 9, 1, 8, 132, False),    # more channels than the tiled kernel takes
])
def test_card_path_takes_any_channel_count(monkeypatch, dtype, b, n, lead, side, c, vector):
    """The card-side checks and launch of ``reference_similarity`` accept
    C != 4 (the template encoder's 8, odd C, and a bf16 query with an odd
    h·w·C, which C = 4 used to refuse), against an emulation of the C entry
    point; no library is loaded."""
    emulated = _EmulatedKernel()

    @contextlib.contextmanager
    def launcher(device):
        yield emulated

    monkeypatch.setattr(_build, "launcher", launcher)
    monkeypatch.setattr(_build, "check_cuda", lambda name, t: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    before = profiling.counters().get("k1.launches", 0)
    rng = np.random.default_rng(b * c + side)
    qt = torch.from_numpy(rng.normal(size=(b, side, side, c)).astype(np.float32)).to(dtype)
    tt = torch.from_numpy(rng.normal(size=(lead, n, side, side, c)).astype(np.float32)).to(dtype)
    got = sim._kernel_similarity(qt, tt)
    torch.testing.assert_close(got, sim.reference_similarity_plain(qt, tt), rtol=1e-5, atol=1e-4)
    (call,) = emulated.calls
    want_vector = (dtype == torch.float32) if vector is None else vector
    want_step = sim.pixel_step(c, qt.element_size()) if want_vector else 0
    assert call[7:10] == (c, int(lead == b and b > 1), want_step)
    assert profiling.counters().get("k1.launches", 0) - before == 1
