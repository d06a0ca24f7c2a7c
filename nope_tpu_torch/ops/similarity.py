"""Template-bank similarity and retrieval (``nope_tpu/ops/similarity.py``).

The reference "l2" metric is an L4-flavoured channel reduction:

    sim[b, n] = -sum_{h,w} sqrt(sum_c ((q - t)^2)^2)

:func:`reference_similarity` runs the K1 CUDA kernel
(``csrc/similarity.cu``) for CUDA tensors and
:func:`reference_similarity_plain` for CPU tensors.  The kernel tiles
(query, template) pairs and, where the tiles do not fill the card,
splits the pixels over blocks (:func:`similarity_plan`);
:func:`similarity_partials_plain` is the plain version of its per-split
sums.  The kernel and the plain version load the input dtype, compute
in float32 and return float32.  ``l2_true`` and
``cosine`` are plain PyTorch only.

Layout is NHWC: query (B, h, w, C), bank (B or 1, N, h, w, C).  A bank
with leading dim 1 is scored against every query without a copy.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from nope_tpu_torch.ops import _build


def _check_shapes(query: torch.Tensor, bank: torch.Tensor) -> None:
    if query.dim() != 4 or bank.dim() != 5 or bank.shape[2:] != query.shape[1:]:
        raise ValueError(f"expected query (B,h,w,C) and bank (B|1,N,h,w,C), got "
                         f"{tuple(query.shape)} and {tuple(bank.shape)}")
    if bank.shape[0] not in (1, query.shape[0]):
        raise ValueError(f"bank leading dim {bank.shape[0]} is neither 1 nor B={query.shape[0]}")


def reference_similarity_plain(query: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K1: (B,h,w,C) x (B|1,N,h,w,C) → (B,N) float32."""
    _check_shapes(query, bank)
    diff2 = torch.square(query.float()[:, None] - bank.float())
    chan = torch.sqrt(torch.sum(torch.square(diff2), dim=-1))
    return -torch.sum(chan, dim=(-2, -1))


#: pixels the kernel stages a step; templates a block tiles; queries a
#: block tiles when the bank is shared (one per block when it is batched)
PIXEL_STEP, TILE_N, TILE_Q = 64, 32, 8


class SimilarityPlan(NamedTuple):
    pixels: int  # pixels of each split, a whole number of PIXEL_STEP
    splits: int  # ceil(S / pixels) blocks share a pair's pixels


def similarity_plan(b: int, n: int, s: int, batched: bool, sms: int) -> SimilarityPlan:
    """Tiling of K1 for B = ``b`` queries, ``n`` templates and ``s``
    pixels on a card with ``sms`` SMs: (TILE_Q or 1) × TILE_N pair tiles,
    and where they are fewer than 16 blocks an SM (four waves of the four
    blocks an SM holds), the pixels split over blocks in whole steps.
    (On an H100, bf16, B=64 N=341: 16 splits took 0.032 ms, 3 splits
    0.038 ms; at every serving shape more splits were faster;
    ``scripts/k1_k2_plans.py``.)"""
    tq = 1 if batched else TILE_Q
    tiles = -(-b // tq) * -(-n // TILE_N)
    steps = -(-s // PIXEL_STEP)
    per_split = -(-steps // min(steps, -(-16 * sms // tiles)))
    pixels = per_split * PIXEL_STEP
    return SimilarityPlan(pixels, -(-s // pixels))


def similarity_partials_plain(query: torch.Tensor, bank: torch.Tensor, pixels: int) -> torch.Tensor:
    """What the K1 kernel sums per pixel split: (splits, B, N) float32, the
    positive sum over each range of ``pixels`` pixels (row-major h·w)."""
    _check_shapes(query, bank)
    b, h, w, c = query.shape
    q = query.float().reshape(b, 1, h * w, c)
    t = bank.float().reshape(bank.shape[0], bank.shape[1], h * w, c)
    parts = []
    for s0 in range(0, h * w, pixels):
        d2 = torch.square(q[:, :, s0:s0 + pixels] - t[:, :, s0:s0 + pixels])
        parts.append(torch.sqrt(torch.sum(torch.square(d2), dim=-1)).sum(-1))
    return torch.stack(parts)


def _batched(query: torch.Tensor, bank: torch.Tensor) -> bool:
    """A bank per query (leading dim B > 1): no template is shared."""
    return bank.shape[0] == query.shape[0] > 1


def _launch(query: torch.Tensor, bank: torch.Tensor, out: torch.Tensor, plan: SimilarityPlan) -> None:
    """The kernel's launch for query (B, h, w, 4) and bank (B|1, N, h, w, 4)
    into out (B, N) float32."""
    b, h, w, _ = query.shape
    n = bank.shape[1]
    ws = None
    if plan.splits > 1:
        ws = torch.empty(plan.splits * b * n, dtype=torch.float32, device=query.device)
    with _build.launcher(query.device) as call:
        call("nope_reference_similarity", query.data_ptr(), bank.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), b, n, h * w, int(_batched(query, bank)), plan.pixels,
             plan.splits, _build.DTYPE_CODES[query.dtype])


def reference_similarity(query: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """K1: the reference "l2" score, (B, N) float32."""
    if query.device.type == "cpu" and bank.device.type == "cpu":
        return reference_similarity_plain(query, bank)
    _check_shapes(query, bank)
    _build.check_cuda("query", query)
    _build.check_cuda("bank", bank)
    if bank.dtype != query.dtype or bank.device != query.device:
        raise ValueError("query and bank must share dtype and device")
    b, h, w, c = query.shape
    n = bank.shape[1]
    if c != 4:
        raise ValueError(f"the kernel reads one 4-channel pixel per load; got C={c}")
    if query.data_ptr() % 16 or bank.data_ptr() % 16:
        raise ValueError("query and bank must be 16-byte aligned")
    if (h * w * query.element_size()) % 4:
        raise ValueError(f"a bfloat16 query needs an even pixel count, got {h * w}")
    out = torch.empty(b, n, dtype=torch.float32, device=query.device)
    if out.numel():
        plan = similarity_plan(b, n, h * w, _batched(query, bank), _build.sm_count(query.device))
        _launch(query, bank, out, plan)
        reference_similarity.launches += 1
    return out


reference_similarity.launches = 0


def _flat(query: torch.Tensor, bank: torch.Tensor):
    b = query.shape[0]
    q = query.reshape(b, -1)
    t = bank.reshape(bank.shape[0], bank.shape[1], -1).expand(b, -1, -1)
    return q, t


def l2_similarity(query: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """True negative squared L2 distance, expanded as ‖q‖² - 2q·t + ‖t‖²."""
    q, t = _flat(query, bank)
    qq = torch.sum(q * q, dim=-1)[:, None]
    tt = torch.sum(t * t, dim=-1)
    qt = torch.einsum("bd,bnd->bn", q, t)
    return -(qq - 2.0 * qt + tt)


def cosine_similarity(query: torch.Tensor, bank: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    q, t = _flat(query, bank)
    qn = torch.linalg.norm(q, dim=-1)[:, None]
    tn = torch.linalg.norm(t, dim=-1)
    return torch.einsum("bd,bnd->bn", q, t) / torch.clamp(qn * tn, min=eps)


_METRICS = {
    "l2": reference_similarity,  # the reference calls its quirk metric "l2"
    "l2_true": l2_similarity,
    "cosine": cosine_similarity,
}


def similarity_metric(name: str):
    """Similarity function by config name: (B,h,w,C) query x
    (B|1,N,h,w,C) bank → (B,N)."""
    return _METRICS[name]


def top_k(sim: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, k) of the k largest scores, best first, equal scores
    in index order, as ``jax.lax.top_k`` orders them (``torch.topk``
    leaves the order of ties unspecified): the first k of a stable
    descending sort."""
    return torch.sort(sim, dim=-1, descending=True, stable=True).indices[..., :k]


def retrieve(
    query: torch.Tensor, bank: torch.Tensor, k: int = 5, metric: str = "l2"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """similarity (B, N) + top-k indices (B, k), best first."""
    sim = _METRICS[metric](query, bank)
    return sim, top_k(sim, k)
