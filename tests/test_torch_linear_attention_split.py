"""K2's split over token chunks, in plain torch on the CPU: the per-chunk
softmax partials, their merge in chunk order and the output step against
the JAX package's composition and its Pallas kernel in interpret mode;
the chunk plan; and the wrapper's launches run against an emulation of
the C entry points on host memory."""

import contextlib
import ctypes
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nope_tpu.ops.experimental.linear_attention import (
    linear_attention_inner as jax_kernel,
    linear_attention_inner_xla as jax_plain,
)
from nope_tpu_torch.ops import _build
from nope_tpu_torch.ops import linear_attention as la

torch.set_num_threads(1)

HEADS, DH = 4, 32


def _qkv(b, n, seed, spread=2.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 3 * HEADS * DH)) * spread).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_refs(b, n, seed):
    qkv = jnp.asarray(_qkv(b, n, seed))
    with jax.default_matmul_precision("highest"):
        plain = np.asarray(jax_plain(qkv, HEADS, DH))
        kernel = np.asarray(jax_kernel(qkv, HEADS, DH, block_b=1, interpret=True))
    return plain, kernel


def _split_chain(qkv: torch.Tensor, chunk_len: int) -> torch.Tensor:
    m, l, ctx_c = la.attention_partials_plain(qkv, HEADS, DH, chunk_len)
    return la.attention_output_plain(qkv, la.attention_merge_plain(m, l, ctx_c), HEADS, DH)


@pytest.mark.parametrize("n", [16, 64, 256, 1024])
@pytest.mark.parametrize("chunk_len", [16, 64, 128, 256])
def test_split_chain_matches_jax_and_pallas_interpret(chunk_len, n):
    b = 2
    qkv = _qkv(b, n, seed=n)
    m, l, ctx_c = la.attention_partials_plain(torch.from_numpy(qkv), HEADS, DH, chunk_len)
    assert m.shape == l.shape == (b, -(-n // chunk_len), HEADS, DH)
    assert ctx_c.shape == (b, -(-n // chunk_len), HEADS, DH, DH)
    got = _split_chain(torch.from_numpy(qkv), chunk_len).numpy()
    plain, kernel = _jax_refs(b, n, n)
    # float32 softmax and two small contractions, summed in another order
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)


def test_merge_holds_when_column_maxima_sit_in_different_chunks():
    """k spread to ±30: exp(k − m) underflows across chunks unless each
    chunk's partial is rescaled by its own max; here channel d peaks in
    chunk d % 4, at +30, over a field of −30..+10."""
    b, n, chunk_len = 2, 256, 64
    qkv = _qkv(b, n, seed=7)
    rng = np.random.default_rng(8)
    hidden = HEADS * DH
    qkv[..., hidden:2 * hidden] = rng.uniform(-30, 10, size=(b, n, hidden))
    for d in range(hidden):
        qkv[:, (d % 4) * chunk_len + d % chunk_len, hidden + d] = 30.0
    m, _, _ = la.attention_partials_plain(torch.from_numpy(qkv), HEADS, DH, chunk_len)
    peak = m.reshape(b, n // chunk_len, hidden).argmax(1)
    assert set(peak.flatten().tolist()) == {0, 1, 2, 3}
    got = _split_chain(torch.from_numpy(qkv), chunk_len).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_plain(jnp.asarray(qkv), HEADS, DH))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _split_chain(torch.from_numpy(qkv), n).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,n,sms,fp32,want", [
    (26, 1024, 132, False, (128, 8)),    # 26 items x 8 chunks = 208 blocks, >= 1.5 x 132
    (26, 256, 132, False, (64, 4)),      # chunks of at least 64 tokens
    (26, 64, 132, False, (64, 1)),       # one chunk: one launch
    (26, 16, 132, False, (64, 1)),
    (341, 1024, 132, False, (1024, 1)),  # the items alone fill the card
    (3, 1024, 132, False, (64, 16)),
    (1, 8192, 132, False, (128, 64)),    # at most 64 chunks
    (26, 100, 132, False, (64, 2)),      # ragged last chunk
    (341, 1024, 132, True, (256, 4)),    # float32: chunks of at most 256 tokens
    (341, 256, 132, True, (256, 1)),
    (26, 1024, 132, True, (128, 8)),
    (26, 16, 132, True, (64, 1)),
    (1, 32768, 132, True, (512, 64)),    # at most 64 chunks before at most 256 tokens
])
def test_attention_plan(b, n, sms, fp32, want):
    plan = la.attention_plan(b, n, sms, fp32)
    assert tuple(plan) == want
    assert plan.chunk_len % la.TOKEN_STEP == 0 and plan.chunks <= la.MAX_CHUNKS
    assert (plan.chunks - 1) * plan.chunk_len < n <= plan.chunks * plan.chunk_len


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
    """The C entry points of csrc/linear_attention.cu on host memory, by
    what each kernel computes, with the layouts the kernels write."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, *args):
        self.calls.append((name, args))
        getattr(self, name)(*args)

    def nope_la_chunks(self, qkv, part, out, b, n, chunk_len, chunks, scale, dt):
        assert chunks == -(-n // chunk_len) and scale == DH ** -0.5
        x = _view(qkv, b * n * 3 * HEADS * DH, dt).reshape(b, n, -1)
        m, l, ctx_c = la.attention_partials_plain(x, HEADS, DH, chunk_len)
        if part is None:
            assert chunks == 1
            _store(out, b * n * HEADS * DH, dt, la.attention_output_plain(x, ctx_c[:, 0] / l[:, 0, ..., None], HEADS, DH))
            return
        assert out is None
        flat = torch.cat([m, l, ctx_c.flatten(-2)], dim=-1)  # (b, chunks, h, PART)
        _store(part, b * chunks * HEADS * la.PART, 0, flat)

    def nope_la_merge(self, part, ctx, b, chunks):
        flat = _view(part, b * chunks * HEADS * la.PART, 0).reshape(b, chunks, HEADS, la.PART).clone()
        m, l, ctx_c = flat[..., :DH], flat[..., DH:2 * DH], flat[..., 2 * DH:].reshape(b, chunks, HEADS, DH, DH)
        _store(ctx, b * HEADS * DH * DH, 0, la.attention_merge_plain(m, l, ctx_c))

    def nope_la_output(self, qkv, ctx, out, b, n, chunk_len, chunks, scale, dt):
        x = _view(qkv, b * n * 3 * HEADS * DH, dt).reshape(b, n, -1)
        c = _view(ctx, b * HEADS * DH * DH, 0).reshape(b, HEADS, DH, DH).clone()
        _store(out, b * n * HEADS * DH, dt, la.attention_output_plain(x, c, HEADS, DH))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,sms", [(3, 256, 132), (2, 100, 132), (26, 64, 132), (4, 128, 1), (8, 512, 1)])
def test_launches_match_the_plain_version(monkeypatch, dtype, b, n, sms):
    emulated = _EmulatedKernels()

    @contextlib.contextmanager
    def launcher(device):
        yield emulated

    monkeypatch.setattr(_build, "launcher", launcher)
    qkv = torch.from_numpy(_qkv(b, n, seed=b + n)).to(dtype)
    plan = la.attention_plan(b, n, sms, dtype == torch.float32)
    out = torch.empty(b, n, HEADS * DH, dtype=dtype)
    la._launch(qkv, out, plan)
    want = la.linear_attention_inner_plain(qkv.float(), HEADS, DH)
    err = (out.float() - want).abs().max() / want.abs().max()
    # bf16: the output is rounded to bf16 (the chip's tolerance); float32 as the JAX test
    assert err <= (1e-2 if dtype == torch.bfloat16 else 1e-5), err
    names = [name for name, _ in emulated.calls]
    if plan.chunks == 1:
        assert names == ["nope_la_chunks"]
        return
    assert names == ["nope_la_chunks", "nope_la_merge", "nope_la_output"]
    (_, chunk_args), (_, merge_args), (_, out_args) = emulated.calls
    part, ctx = merge_args[0], merge_args[1]
    assert chunk_args[1] == part and chunk_args[6] == out_args[6] == merge_args[3] == plan.chunks
    assert ctx - part == 4 * b * plan.chunks * HEADS * la.PART  # scratch: partials, then ctx
    assert out_args[1] == ctx and out_args[2] == out.data_ptr()
    assert chunk_args[0] == out_args[0] == qkv.data_ptr()

