"""Template-parallel evaluation over the rank mesh (``nope_tpu/parallel/eval.py``).

The eval-time analogue of sequence parallelism is the SO(3) template
axis: the N U-Net forwards of each query are independent, so each rank
of a template group sweeps an N/T slice of the pose grid, and only the
(B/D, N/T) similarity rows cross between ranks, gathered in rank order
(the U-Net's work needs no communication at all).  The data axis splits
the batch.  Every rank ends with the single-device result.

On the card each rank's sweep runs K3 and K2 in every U-Net forward and
K1 in the scoring of each chunk.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from nope_tpu_torch.ops.similarity import similarity_metric, top_k
from nope_tpu_torch.parallel.mesh import DATA_AXIS, TEMPLATE_AXIS, Mesh, all_gather


def local_chunk(chunk_size: Optional[int], n_local: int) -> int:
    """``chunk_size`` is a memory budget, not a contract: the rank's
    template count N/T depends on the mesh, so a request that does not
    divide it is rounded down to the nearest divisor (the single-device
    ``retrieve_streaming`` raises instead)."""
    cs = min(chunk_size or n_local, n_local)
    while n_local % cs:
        cs -= 1
    return cs


def _check_template_count(n: int, mesh: Mesh) -> None:
    if n % mesh.template:
        raise ValueError(
            f"template count {n} is not divisible by the "
            f"template mesh axis ({mesh.template}); pick a mesh whose "
            "template axis divides the grid size"
        )


def template_parallel_similarity(
    task, query_latent: torch.Tensor, reference_latent: torch.Tensor, bank_relativeR: torch.Tensor,
    mesh: Mesh, chunk_size: Optional[int] = None, materialise: bool = False,
) -> torch.Tensor:
    """(B', N) similarity of this rank's B' queries against all N
    templates, each rank of the template group scoring its N/T slice of
    ``bank_relativeR`` (B', N, pose_dim): streamed in chunks, or with
    ``materialise`` the slice's bank made whole first.  N must be a
    multiple of the template axis (the callers check it)."""
    n_local = bank_relativeR.shape[1] // mesh.template
    t = mesh.index(TEMPLATE_AXIS)
    rel = bank_relativeR[:, t * n_local:(t + 1) * n_local]
    cs = local_chunk(chunk_size, n_local)
    if materialise:
        bank = task.generate_template_bank(None, rel, cs, reference_latent)
        sim = similarity_metric(task.config.similarity_metric)(query_latent, bank)
    else:
        sim = task.stream_similarity(query_latent, reference_latent, rel, cs)
    # the slices re-join in rank order, which is template order
    return all_gather(sim, mesh.group(TEMPLATE_AXIS), dim=1)


def _runner(task, mesh: Mesh, chunk_size: Optional[int], materialise: bool) -> Callable:
    def run(reference, query, bank_R) -> Tuple[torch.Tensor, torch.Tensor]:
        device = task.device
        dtype = next(task.unet.parameters()).dtype
        bank_R = torch.as_tensor(np.asarray(bank_R) if not torch.is_tensor(bank_R) else bank_R)
        _check_template_count(bank_R.shape[1], mesh)
        b = bank_R.shape[0]
        if b % mesh.data:
            raise ValueError(f"batch size {b} is not divisible by the data mesh axis ({mesh.data}); "
                             "adjust machine.batch_size")
        d = mesh.index(DATA_AXIS)
        rows = slice(d * (b // mesh.data), (d + 1) * (b // mesh.data))

        def put(x):
            x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)[rows]
            return x.to(device, dtype if x.is_floating_point() else x.dtype)

        with torch.no_grad():
            ref_latent, q_latent = task.encode(put(reference)), task.encode(put(query))
            sim = template_parallel_similarity(task, q_latent, ref_latent, put(bank_R), mesh, chunk_size,
                                               materialise)
            sim = all_gather(sim, mesh.group(DATA_AXIS), dim=0)
        return sim, top_k(sim, task.config.retrieval_k)

    return run


def make_sharded_streaming_eval_fn(task, mesh: Mesh, chunk_size: Optional[int] = None) -> Callable:
    """Template-parallel *streaming* retrieval: ``run(reference, query,
    bank_R) → (similarity (B, N), top-k idx (B, k))``, the single-device
    result on every rank.  Every rank passes the whole batch (host arrays
    or tensors); it encodes its B/D rows and streams its N/T slice of the
    grid in ``chunk_size`` chunks, scoring each chunk as it is made, so the
    bank never exists anywhere.  The task's modules (and their dtype) are
    the rank's.  An N the template axis does not divide raises."""
    return _runner(task, mesh, chunk_size, materialise=False)


def make_sharded_eval_fn(task, mesh: Mesh, chunk_size: Optional[int] = None) -> Callable:
    """As :func:`make_sharded_streaming_eval_fn`, with each rank's
    (B/D, N/T) slice of the bank made whole before it is scored."""
    return _runner(task, mesh, chunk_size, materialise=True)
