"""The inner chain of linear attention
(``nope_tpu/ops/experimental/linear_attention.py``).

For each batch item and head: q ← softmax over the d channels times
d^-½, k ← softmax over the n tokens, context = kᵀv (d×e),
out = q·context (n×e).  Channels are split heads-major, as the
reference's ``b (h c) ... -> b h c ...``.

:func:`linear_attention_inner` runs the K2 CUDA kernel
(``csrc/linear_attention.cu``) for CUDA tensors and
:func:`linear_attention_inner_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from nope_tpu_torch.ops import _build


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


def linear_attention_inner(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """K2: (B, n, 3·heads·dim_head) → (B, n, heads·dim_head) in qkv's dtype."""
    b, n, three_hidden = qkv.shape
    hidden = heads * dim_head
    if three_hidden != 3 * hidden:
        raise ValueError(f"qkv width {three_hidden} != 3 * {heads} * {dim_head}")
    if qkv.device.type == "cpu":
        return linear_attention_inner_plain(qkv, heads, dim_head)
    _build.check_cuda("qkv", qkv)
    if dim_head != 32:
        raise ValueError(f"the kernel is built for dim_head 32, got {dim_head}")
    out = torch.empty(b, n, hidden, dtype=qkv.dtype, device=qkv.device)
    if out.numel():
        _build.launch(
            "nope_linear_attention", qkv.device, qkv.data_ptr(), out.data_ptr(), b, n, heads,
            dim_head**-0.5, _build.DTYPE_CODES[qkv.dtype],
        )
        linear_attention_inner.launches += 1
    return out


linear_attention_inner.launches = 0
