"""The rank mesh and its collectives (``nope_tpu/parallel/mesh.py``).

The JAX package lays a 2-axis ``jax.sharding.Mesh`` over its devices:

- ``data``: batch-parallel training (the reference's DDP);
- ``template``: the SO(3) template sweep of evaluation, split into
  slices of the pose grid.

Here each device is a process (a rank of ``torch.distributed``), and the
mesh is a (data, template) grid of ranks, row-major as JAX reshapes its
devices: rank r sits at data index r // T and template index r % T.
Every axis has its own process group.  There is no compiler to place
arrays: a rank takes its slice of a host array itself
(:class:`Sharding`, :func:`shard_eval_batch`, :func:`shard_batch`), and
the collectives are explicit (:func:`all_gather`, :func:`all_reduce_mean_`,
:func:`all_gather_host`).

Launch with ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) and call :func:`initialize_distributed`
first; NCCL carries the collectives between GPUs, gloo between CPU
processes.  Two ranks on one GPU need gloo (NCCL refuses a GPU twice):
gloo reduces and broadcasts CUDA tensors itself, and :func:`all_gather`
moves them through host memory, which it does only under gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
TEMPLATE_AXIS = "template"

#: how long a collective or a rendezvous waits for the other ranks
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

# one bucket of a gradient all-reduce, as DDP's default
BUCKET_BYTES = 25 * 2**20


def _rank_device(device) -> torch.device:
    """``cuda`` → ``cuda:LOCAL_RANK``; an explicit index or ``cpu`` as given."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def initialize_distributed(
    backend: Optional[str] = None,
    device=None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> torch.device:
    """Join the process group of a multi-process launch and return this
    rank's device (``cuda:LOCAL_RANK`` unless ``device`` names another).

    ``torchrun`` sets the variables read here (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); ``init_method``
    (e.g. a ``file://`` store) with ``rank`` and ``world_size`` replaces
    them.  With neither, as JAX does on a plain single process, nothing
    is initialised.  The backend is NCCL for a CUDA device and gloo for
    the CPU unless ``backend`` names one.  A group that is already
    initialised is kept."""
    device = _rank_device(device)
    if dist.is_initialized():
        return device
    hinted = init_method is not None or "WORLD_SIZE" in os.environ or "MASTER_ADDR" in os.environ
    if not hinted:
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend,
        init_method=init_method or "env://",
        rank=-1 if rank is None else rank,  # -1: read from the environment
        world_size=-1 if world_size is None else world_size,
        timeout=timeout,
    )
    return device


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_barrier(tag: str = "nope") -> None:
    """Wait until every rank arrives.  A no-op with one process.  ``tag``
    names the barrier for the reader (JAX's coordination service keys
    its barriers by it; ``dist.barrier`` needs none)."""
    if process_count() <= 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, template) grid of ranks and this rank's place in it.
    ``groups`` maps each axis to the process group of the ranks that share
    this rank's other coordinate; without a process group it is empty."""

    data: int
    template: int
    rank: int = 0
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, TEMPLATE_AXIS: self.template}

    @property
    def size(self) -> int:
        return self.data * self.template

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.rank // self.template if axis == DATA_AXIS else self.rank % self.template

    def group(self, axis: str):
        return self.groups.get(axis)


def create_mesh(data: Optional[int] = None, template: int = 1) -> Mesh:
    """Build a (data, template) mesh over the ranks.  By default all ranks
    go to the data axis; ``template=k`` carves out template parallelism.

    Unlike JAX's mesh, which may take the first devices only, every rank
    takes a place: a mesh smaller than the world raises.  The groups are
    made with ``dist.new_group`` by every rank in the same order (each
    template column's data group, then each data row's template group);
    ``init_device_mesh`` would make the same groups, but it also moves
    the rank to ``cuda:LOCAL_RANK`` and so cannot put two ranks on one card."""
    world = process_count()
    if template < 1:
        raise ValueError(f"template axis must be >= 1, got {template}")
    if data is None:
        data = world // template
    if data < 1:
        raise ValueError(f"data axis must be >= 1, got {data}")
    if data * template > world:
        raise ValueError(f"mesh {data}x{template} > {world} devices")
    if data * template < world:
        raise ValueError(f"mesh {data}x{template} < {world} ranks: every rank takes a place in the mesh")
    rank = process_index()
    groups: Dict[str, Any] = {}
    if dist.is_available() and dist.is_initialized():
        for t in range(template):
            g = dist.new_group([d * template + t for d in range(data)])
            if rank % template == t:
                groups[DATA_AXIS] = g
        for d in range(data):
            g = dist.new_group([d * template + t for t in range(template)])
            if rank // template == d:
                groups[TEMPLATE_AXIS] = g
    return Mesh(data, template, rank, groups)


# -- this rank's slice of a host array ----------------------------------------


class Sharding:
    """The host-slicing counterpart of a ``NamedSharding``: ``spec`` names
    the mesh axis each leading dimension is split over (None: whole);
    calling it on an array returns this rank's slice."""

    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]] = ()):
        self.mesh, self.spec = mesh, tuple(spec)

    def __call__(self, x):
        index = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                index.append(slice(None))
                continue
            n, parts = x.shape[dim], self.mesh.shape[axis]
            if n % parts:
                raise ValueError(f"dimension {dim} of size {n} is not divisible by the {axis} mesh axis ({parts})")
            i = self.mesh.index(axis)
            index.append(slice(i * (n // parts), (i + 1) * (n // parts)))
        return x[tuple(index)]


def data_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """The leading (batch) axis split over the data axis."""
    return Sharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def template_sharding(mesh: Mesh, axis: int = 1, ndim: int = 2) -> Sharding:
    """A bank-like array's template axis (default axis 1 of (B, N, ...))
    split over the template axis."""
    spec = [None] * ndim
    spec[axis] = TEMPLATE_AXIS
    return Sharding(mesh, spec)


def replicate(mesh: Mesh) -> Sharding:
    """The whole array on every rank."""
    return Sharding(mesh, ())


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's slice of a (nested dict) batch of host arrays, the
    leading axis split over the data axis."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    return data_sharding(mesh, np.ndim(batch))(batch)


def check_template_divides(key: str, n: int, n_template: int) -> None:
    if n % n_template:
        raise ValueError(
            f"{key} template count {n} is not divisible by the "
            f"template mesh axis ({n_template}); pick --mesh-template "
            f"dividing the grid size"
        )


def shard_eval_batch(batch: Dict[str, Any], mesh: Mesh, template_keys=("all_relativeR",)) -> Dict[str, np.ndarray]:
    """This rank's slice of an eval batch: bank-like keys split (data,
    template), other arrays the batch axis, scalars whole, with the JAX
    package's up-front messages for a size an axis does not divide."""
    n_data, n_template = mesh.data, mesh.template

    def take(k, v):
        v = np.asarray(v)
        if k in template_keys:
            check_template_divides(k, v.shape[1], n_template)
            spec = (DATA_AXIS, TEMPLATE_AXIS)
        elif v.ndim >= 1:
            spec = (DATA_AXIS,)
        else:
            spec = ()
        if v.ndim >= 1 and v.shape[0] % n_data:
            raise ValueError(
                f"batch size {v.shape[0]} (key {k!r}) is not divisible by the "
                f"data mesh axis ({n_data}); adjust machine.batch_size"
            )
        return Sharding(mesh, spec)(v)

    return {k: take(k, v) for k, v in batch.items()}


# -- collectives ----------------------------------------------------------------


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` (one shape on every rank) concatenated along
    ``dim`` in rank order; ``x`` itself without a group."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "gloo":
        # gloo has no CUDA all-gather: under gloo, and only there, a CUDA
        # tensor goes through host memory (NCCL gathers on the device);
        # bfloat16 crosses as float32 (exact), which every gloo build gathers
        src = x.detach().to("cpu", torch.float32 if x.dtype == torch.bfloat16 else x.dtype).contiguous()
    else:
        src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(x.device, x.dtype)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Average ``tensors`` over ``group`` in place: a SUM, then a division
    by the group's size (gloo has no AVG).  Tensors go in buckets of about
    ``bucket_bytes``, consecutive in list order, so every rank sends the
    same buckets in the same order.  A no-op without a group; a group of
    one still runs its (identity) all-reduce."""
    if group is None:
        return
    n = dist.get_world_size(group)
    bucket: list = []
    size = 0
    for t in list(tensors) + [None]:
        if bucket and (t is None or size + t.numel() * t.element_size() > bucket_bytes
                       or t.dtype != bucket[0].dtype or t.device != bucket[0].device):
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            flat.div_(n)
            offset = 0
            for b in bucket:
                b.copy_(flat[offset:offset + b.numel()].view_as(b))
                offset += b.numel()
            bucket, size = [], 0
        if t is not None:
            bucket.append(t)
            size += t.numel() * t.element_size()


def _collective_device() -> torch.device:
    """Where host arrays go for a collective of the world group: this
    rank's GPU under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_host(array: np.ndarray, group=None) -> np.ndarray:
    """The ranks' numpy ``array`` (one shape on every rank) stacked in rank
    order on a new leading axis."""
    x = torch.from_numpy(np.ascontiguousarray(array)).to(_collective_device())
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts).cpu().numpy()
