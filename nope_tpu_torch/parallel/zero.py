"""ZeRO-1: the optimizer state split over the data axis (``nope_tpu/parallel/zero.py``).

Data parallelism keeps the parameters, the gradients and the AdamW
moments whole on every rank; the moments are twice the parameters'
bytes.  ZeRO stage 1 (Rajbhandari et al., 2019) keeps parameters and
gradients whole but gives each rank of the data axis the moments of a
part of the parameters only: each rank updates its part from the
all-reduced gradients, then broadcasts it.  The update's arithmetic does
not change, so the numerics equal the replicated step's.

The JAX package gets this from a sharding annotation on each moment
leaf of at least 16,384 elements (each leaf split along one axis).
Here it is ``torch.distributed.optim.ZeroRedundancyOptimizer`` as the
inner optimizer of ``training.optim.Optimizer``: it partitions
whole parameters, the largest first, each onto the rank holding the
fewest elements so far, so a rank's share exceeds 1/D of the moments by
at most one parameter's.  Clipping and skip-spike act on the all-reduced
gradients before the inner step, as in the replicated step.

Usage::

    shardings = zero1_state_shardings(state, mesh)  # the optimizer becomes ZeRO-1
    step = make_train_step(task, state_shardings=shardings)
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List

import torch

from nope_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


@dataclasses.dataclass(frozen=True)
class StateShardings:
    """What :func:`zero1_state_shardings` hands to ``make_train_step``: the
    mesh whose data axis holds the optimizer state."""

    mesh: Mesh


def zero1_state_shardings(state, mesh: Mesh) -> StateShardings:
    """Make ``state``'s optimizer ZeRO-1 over ``mesh``'s data axis, in
    place, before its first step, and return the record that
    ``make_train_step(state_shardings=...)`` takes.  (JAX returns the
    sharding pytree that ``device_put`` applies; here the layout is the
    optimizer itself.)  Without a process group the data axis is one
    rank, whose share is everything: the optimizer stays as it is."""
    group = mesh.group(DATA_AXIS)
    if group is not None:
        state.opt.shard(group)
    return StateShardings(mesh)


def _params(state_or_params) -> List[torch.Tensor]:
    if hasattr(state_or_params, "unet"):
        return list(state_or_params.unet.parameters())
    return list(state_or_params)


def zero1_partition(params: Iterable[torch.Tensor], n_shards: int) -> List[List[int]]:
    """The indices of ``params`` each of ``n_shards`` ranks updates, as
    ``ZeroRedundancyOptimizer`` partitions one parameter group: the
    largest first, each onto the rank with the fewest elements so far
    (the lowest rank on a tie)."""
    params = list(params)
    order = sorted(range(len(params)), key=lambda i: params[i].numel(), reverse=True)
    sizes, parts = [0] * n_shards, [[] for _ in range(n_shards)]
    for i in order:
        r = sizes.index(min(sizes))
        parts[r].append(i)
        sizes[r] += params[i].numel()
    return parts


def sharded_param_bytes(state_or_params, mesh: Mesh) -> dict:
    """Bytes of AdamW's state per rank: ``opt_state_replicated`` (two
    moments of every parameter's size and dtype, and each parameter's
    float32 step count) and ``opt_state_zero1``, the largest rank's share
    under :func:`zero1_partition` over the data axis.  Only shapes and
    dtypes are read: parameters on the ``meta`` device do."""
    params = _params(state_or_params)

    def nbytes(p):
        return 2 * p.numel() * p.element_size() + 4

    parts = zero1_partition(params, mesh.shape[DATA_AXIS])
    return {
        "opt_state_replicated": sum(nbytes(p) for p in params),
        "opt_state_zero1": max(sum(nbytes(params[i]) for i in part) for part in parts),
    }
