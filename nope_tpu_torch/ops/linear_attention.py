"""The inner chain of linear attention
(``nope_tpu/ops/experimental/linear_attention.py``).

For each batch item and head: q ← softmax over the d channels times
d^-½, k ← softmax over the n tokens, context = kᵀv (d×e),
out = q·context (n×e).  Channels are split heads-major, as the
reference's ``b (h c) ... -> b h c ...``.

:func:`linear_attention_inner` runs the K2 CUDA kernels
(``csrc/linear_attention.cu``) for CUDA tensors and
:func:`linear_attention_inner_plain` for CPU tensors; each kernel call
counts ``k2.launches`` (``utils.profiling.counters``).  The kernels split
each item's tokens into chunks (:func:`attention_plan`), write per-chunk
softmax partials, merge them in chunk order and apply q; with one chunk
a single launch does the whole chain.  :func:`attention_partials_plain`,
:func:`attention_merge_plain` and :func:`attention_output_plain` are the
plain versions of those three steps, for the tests.

:func:`linear_attention` adds the gradient: its backward recomputes
through :func:`linear_attention_inner_plain` in qkv's dtype (the JAX op
has no VJP of its own; JAX differentiates its XLA composition).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nope_tpu_torch.ops import _build
from nope_tpu_torch.utils import profiling

#: the kernels' geometry: 4 heads of 32 channels, 32 tokens staged a step
HEADS, DIM_HEAD, TOKEN_STEP = 4, 32, 32
#: a chunk has at least this many tokens; an item at most this many chunks
MIN_CHUNK, MAX_CHUNKS = 64, 64
#: a float32 chunk has at most this many tokens (where MAX_CHUNKS allows)
MAX_CHUNK_F32 = 256
#: floats of one (item, chunk, head) partial: m (d), l (d), ctx_c (d × e)
PART = 2 * DIM_HEAD + DIM_HEAD * DIM_HEAD


def linear_attention_inner_plain(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """(B, n, 3·heads·dim_head) → (B, n, heads·dim_head), plain PyTorch."""
    b, n, _ = qkv.shape
    hidden = heads * dim_head
    q, k, v = torch.split(qkv, hidden, dim=-1)

    def split(t):  # heads-major: (b, n, h, d) → (b, h, d, n)
        return t.reshape(b, n, heads, dim_head).permute(0, 2, 3, 1)

    q, k, v = split(q), split(k), split(v)
    q = torch.softmax(q, dim=-2) * dim_head**-0.5
    k = torch.softmax(k, dim=-1)
    context = torch.einsum("bhdn,bhen->bhde", k, v)
    out = torch.einsum("bhde,bhdn->bhen", context, q)  # (b, h, e, n)
    return out.permute(0, 3, 1, 2).reshape(b, n, hidden)


class AttentionPlan(NamedTuple):
    chunk_len: int  # tokens per chunk (the last may be shorter)
    chunks: int  # ceil(n / chunk_len); 1 = one launch, no merge


def attention_plan(b: int, n: int, sms: int, fp32: bool = False) -> AttentionPlan:
    """Chunks of each item's ``n`` tokens such that ``b`` × chunks is at
    least 1.5 blocks for each of the card's ``sms`` SMs: whole 32-token
    steps, at least ``MIN_CHUNK`` tokens, at most ``MAX_CHUNKS`` chunks.
    Where the items alone fill the card, or n ≤ ``MIN_CHUNK``, one chunk:
    the whole chain in one launch; in float32 (``fp32``), whose CUDA-core
    contractions make a chunk's chain longer, chunks of at most
    ``MAX_CHUNK_F32`` tokens even then.  (On an H100, bf16, 26 items ×
    1024 tokens: 8 chunks of 128 took 0.027 ms, 11 of 96 0.032 ms, 16 of
    64 0.031 ms; 341 items × 1024 tokens, one chunk 0.170 ms, 4 of 256
    0.188 ms in bf16 and 0.500 against 0.438 ms in float32;
    ``scripts/k1_k2_plans.py``.)"""
    want = -(-3 * sms // (2 * b))
    chunk = max(MIN_CHUNK, -(-n // want))
    if fp32:
        chunk = min(chunk, MAX_CHUNK_F32)
    chunk = max(chunk, -(-n // MAX_CHUNKS))
    chunk = -(-chunk // TOKEN_STEP) * TOKEN_STEP
    return AttentionPlan(chunk, -(-n // chunk))


def _heads(qkv: torch.Tensor, heads: int, dim_head: int):
    b, n, _ = qkv.shape
    return [t.float().reshape(b, n, heads, dim_head) for t in torch.split(qkv, heads * dim_head, dim=-1)]


def attention_partials_plain(qkv: torch.Tensor, heads: int, dim_head: int, chunk_len: int):
    """What ``la_chunk`` writes, per (item, chunk, head), over the chunk's
    tokens t: m[d] = max_t k[t, d], l[d] = Σ_t exp(k[t, d] − m[d]),
    ctx_c[d, e] = Σ_t exp(k[t, d] − m[d])·v[t, e].  Returns (m, l, ctx_c),
    (B, chunks, h, d), (B, chunks, h, d) and (B, chunks, h, d, e), float32."""
    _, k, v = _heads(qkv, heads, dim_head)
    ms, ls, cs = [], [], []
    for t0 in range(0, qkv.shape[1], chunk_len):
        kc, vc = k[:, t0:t0 + chunk_len], v[:, t0:t0 + chunk_len]
        m = kc.amax(1)
        p = torch.exp(kc - m[:, None])
        ms.append(m)
        ls.append(p.sum(1))
        cs.append(torch.einsum("bthd,bthe->bhde", p, vc))
    return torch.stack(ms, 1), torch.stack(ls, 1), torch.stack(cs, 1)


def attention_merge_plain(m: torch.Tensor, l: torch.Tensor, ctx_c: torch.Tensor) -> torch.Tensor:
    """What ``la_merge`` writes: per (item, head), with M = max_c m_c,
    ctx = Σ_c ctx_c·e^(m_c − M) / Σ_c l_c·e^(m_c − M), over the chunks in
    order: (B, h, d, e)."""
    w = torch.exp(m - m.amax(1, keepdim=True))
    return (ctx_c * w[..., None]).sum(1) / (l * w).sum(1)[..., None]


def attention_output_plain(qkv: torch.Tensor, ctx: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """What ``la_output`` writes: softmax_d(q)·d^-½ · ctx, (B, n, heads·dim_head)
    float32, from ctx (B, h, d, e)."""
    q, _, _ = _heads(qkv, heads, dim_head)
    q = torch.softmax(q, dim=-1) * dim_head**-0.5
    out = torch.einsum("bnhd,bhde->bnhe", q, ctx)
    return out.reshape(qkv.shape[0], qkv.shape[1], heads * dim_head)


def _launch(qkv: torch.Tensor, out: torch.Tensor, plan: AttentionPlan) -> None:
    """The kernels' launches for qkv (B, n, 384) into out (B, n, 128)."""
    b, n, _ = qkv.shape
    dt, scale = _build.DTYPE_CODES[qkv.dtype], DIM_HEAD**-0.5
    scratch = None
    if plan.chunks > 1:  # partials, then the merged ctx
        part_n = b * plan.chunks * HEADS * PART
        scratch = torch.empty(part_n + b * HEADS * DIM_HEAD**2, dtype=torch.float32, device=qkv.device)
        part, ctx = scratch.data_ptr(), scratch.data_ptr() + 4 * part_n
    with _build.launcher(qkv.device) as call:
        if scratch is None:
            call("nope_la_chunks", qkv.data_ptr(), None, out.data_ptr(), b, n, plan.chunk_len, 1, scale, dt)
            return
        call("nope_la_chunks", qkv.data_ptr(), part, None, b, n, plan.chunk_len, plan.chunks, scale, dt)
        call("nope_la_merge", part, ctx, b, plan.chunks)
        call("nope_la_output", qkv.data_ptr(), ctx, out.data_ptr(), b, n, plan.chunk_len, plan.chunks,
             scale, dt)


def linear_attention_inner(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """K2: (B, n, 3·heads·dim_head) → (B, n, heads·dim_head) in qkv's dtype."""
    b, n, three_hidden = qkv.shape
    hidden = heads * dim_head
    if three_hidden != 3 * hidden:
        raise ValueError(f"qkv width {three_hidden} != 3 * {heads} * {dim_head}")
    if qkv.device.type == "cpu":
        return linear_attention_inner_plain(qkv, heads, dim_head)
    _build.check_cuda("qkv", qkv)
    if (heads, dim_head) != (HEADS, DIM_HEAD):
        raise ValueError(f"the kernels are built for {HEADS} heads of {DIM_HEAD}, got {heads} of {dim_head}")
    if qkv.data_ptr() % 16:
        raise ValueError(f"qkv must be 16-byte aligned, got address {qkv.data_ptr():#x}")
    out = torch.empty(b, n, hidden, dtype=qkv.dtype, device=qkv.device)
    if out.numel():
        plan = attention_plan(b, n, _build.sm_count(qkv.device), qkv.dtype == torch.float32)
        _launch(qkv, out, plan)
        profiling.count("k2.launches")
    return out


class _LinearAttentionFn(torch.autograd.Function):
    """K2 forward; backward by recomputing the plain version (counted as
    ``k2.recomputes``, ``utils.profiling.counters``)."""

    @staticmethod
    def forward(ctx, qkv, heads, dim_head):
        ctx.heads, ctx.dim_head = heads, dim_head
        ctx.save_for_backward(qkv)
        return linear_attention_inner(qkv, heads, dim_head)

    @staticmethod
    def backward(ctx, grad):
        (qkv,) = ctx.saved_tensors
        profiling.count("k2.recomputes")
        with torch.enable_grad():
            leaf = qkv.detach().requires_grad_(True)
            out = linear_attention_inner_plain(leaf, ctx.heads, ctx.dim_head)
            (dqkv,) = torch.autograd.grad(out, leaf, grad)
        return dqkv, None, None


def linear_attention(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """Linear attention's inner chain through :func:`linear_attention_inner`,
    with exact gradients through the plain version.  Where no gradient can
    flow (no grad mode, or a qkv that requires none, as when serving) it
    calls :func:`linear_attention_inner` directly, with no autograd node."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _LinearAttentionFn.apply(qkv, heads, dim_head)
    return linear_attention_inner(qkv, heads, dim_head)
