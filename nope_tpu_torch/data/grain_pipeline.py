"""Grain input stack (``nope_tpu/data/grain_pipeline.py``):
``machine.loader=grain``.

The thread-prefetched :class:`nope_tpu_torch.data.pipeline.DataLoader`
is self-contained; this adapter wraps the same map-style datasets in
`grain <https://github.com/google/grain>`_ for worker *processes*,
seeded global shuffling and a record shard per rank.  grain is imported
by the functions that use it.

Ranks come from the initialised ``torch.distributed`` group
(:mod:`nope_tpu_torch.parallel.mesh`): with more than one rank, each
takes record shard ``rank`` of ``world``
(``grain.ShardOptions(drop_remainder=True)``, JAX's
``ShardByJaxProcess``); otherwise ``grain.NoSharding``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np


def _wrap_source(dataset: Any):
    """Adapt a map-style dataset to ``grain.RandomAccessDataSource``
    (single definition shared by both loader builders below)."""
    import grain.python as grain

    class _Source(grain.RandomAccessDataSource):
        def __init__(self, ds):
            self._ds = ds

        def __len__(self):
            return len(self._ds)

        def __getitem__(self, idx):
            return self._ds[int(idx)]

    return _Source(dataset)


def _rank_shard() -> Tuple[int, int]:
    """(rank, world) of the initialised process group; (0, 1) without one."""
    from nope_tpu_torch.parallel.mesh import process_count, process_index

    return process_index(), process_count()


def _shard_options(grain, index: int, count: int):
    if count > 1:
        return grain.ShardOptions(shard_index=index, shard_count=count, drop_remainder=True)
    return grain.NoSharding()


def make_grain_loader(
    dataset: Any,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    num_workers: int = 0,
    num_epochs: Optional[int] = None,
    drop_remainder: bool = True,
    shard_by_process: bool = True,
):
    """Map-style dataset (len + __getitem__ → dict of numpy) → grain
    DataLoader yielding collated numpy batches of ``batch_size`` records.

    ``shard_by_process=True`` splits the index space across the ranks of
    the process group; each rank then batches its own shard.
    """
    import grain.python as grain

    index, count = _rank_shard() if shard_by_process else (0, 1)
    sampler = grain.IndexSampler(
        num_records=len(dataset),
        shuffle=shuffle,
        seed=seed,
        num_epochs=num_epochs,
        shard_options=_shard_options(grain, index, count),
    )
    return grain.DataLoader(
        data_source=_wrap_source(dataset),
        sampler=sampler,
        operations=[grain.Batch(batch_size=batch_size, drop_remainder=drop_remainder)],
        worker_count=num_workers,
    )


class GrainLoader:
    """Epoch-wise grain loader, duck-typed like
    :class:`nope_tpu_torch.data.pipeline.DataLoader` so it drops into
    ``CombinedLoader`` and the ``Trainer`` unchanged.

    Each ``__iter__`` builds a fresh ``grain.DataLoader`` for ONE epoch:
    worker PROCESSES (``num_workers``, grain's ``spawn`` workers) decode
    records, and grain re-sequences them into the sampler's order.  The
    dataset's ``set_epoch`` stream and the shuffle seed advance per
    epoch; the epoch is set BEFORE the workers start, so it reaches them.

    **Ranks and the batch size.**  Alone, on a group of W ranks with
    ``shard_by_process``, each rank reads record shard ``rank`` of W and
    yields batches of ``batch_size`` of its records: the JAX
    ``GrainLoader``'s contract.  Under the data-parallel ``Trainer``,
    which calls :meth:`shard` with the rank's data-axis index and the
    axis size D, ``batch_size`` (``machine.batch_size``) is the step's
    *global* batch, as it is in the JAX package: its ``Trainer`` hands
    each process's batch to ``jax.device_put`` with the data sharding,
    which takes it as the global array (one ``machine.batch_size`` of
    rows a step, whichever loader).  Here a rank then reads
    ``batch_size / D`` records a step from record shard ``index`` of D,
    so the D parts of a step are disjoint and together one global batch
    of ``batch_size`` records, each record is read once an epoch, and
    ranks that share a data index (a template axis) read the same part.

    ``set_state`` supports the Trainer's deterministic mid-epoch resume;
    the skipped batches of the resumed epoch are read and discarded
    (grain's sampler owns the shard-aware index order).
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 0,
        seed: int = 0,
        shard_by_process: bool = True,
        post_batch_fn=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.shard_by_process = shard_by_process
        self.post_batch_fn = post_batch_fn
        self._epoch = 0
        self._start_batch = 0
        self._data_shard: Optional[Tuple[int, int]] = None  # set by shard()

    def shard(self, index: int, count: int) -> "GrainLoader":
        """Read part ``index`` of ``count`` of every global batch: record
        shard ``index`` of ``count``, ``batch_size / count`` records a
        batch (see the class docstring).  The batch size must divide (the
        thread loader's message)."""
        if self.batch_size % count:
            raise ValueError(
                f"batch size {self.batch_size} is not divisible by the "
                f"data mesh axis ({count}); adjust machine.batch_size"
            )
        self._data_shard = (int(index), int(count))
        return self

    def _shard_and_batch(self) -> Tuple[int, int, int]:
        """(record shard index, shard count, records a batch)."""
        if self._data_shard is not None:
            index, count = self._data_shard
            return index, count, self.batch_size // count
        index, count = _rank_shard() if self.shard_by_process else (0, 1)
        return index, count, self.batch_size

    def _local_records(self) -> int:
        _, count, _ = self._shard_and_batch()
        return len(self.dataset) // count  # ShardOptions(drop_remainder=True)

    def __len__(self) -> int:
        n = self._local_records()
        batch = self._shard_and_batch()[2]
        count = n // batch if self.drop_last else -(-n // batch)
        if count == 0:
            raise ValueError(
                f"{n} local records yield 0 batches at batch_size="
                f"{batch} (drop_last={self.drop_last})"
            )
        return count

    def set_state(self, epoch: int, batch_offset: int = 0) -> None:
        """Position the loader for deterministic resume (same contract
        as ``pipeline.DataLoader.set_state``)."""
        self._epoch = int(epoch)
        self._start_batch = int(batch_offset)

    def __iter__(self):
        import grain.python as grain

        from nope_tpu_torch.data.pipeline import collate

        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        index, count, batch_size = self._shard_and_batch()
        # records (not batches) come out of grain: per-record decode runs
        # in the worker processes and grain re-sequences the output into
        # sampler order, so the record stream (and the host-side
        # collation below) is identical for ANY worker count (grain's
        # own Batch runs inside each worker, which makes batch
        # composition a function of worker_count)
        loader = grain.DataLoader(
            data_source=_wrap_source(self.dataset),
            sampler=grain.IndexSampler(
                num_records=len(self.dataset),
                shuffle=self.shuffle,
                seed=self.seed + self._epoch,  # fresh order every epoch
                num_epochs=1,
                shard_options=_shard_options(grain, index, count),
            ),
            operations=[],
            worker_count=self.num_workers,
        )
        self._epoch += 1
        start = self._start_batch
        self._start_batch = 0
        n_batches = len(self)
        buf, emitted = [], 0
        for rec in loader:
            buf.append(rec)
            if len(buf) == batch_size:
                if emitted >= start:
                    batch = collate(buf)
                    yield self.post_batch_fn(batch) if self.post_batch_fn else batch
                buf.clear()
                emitted += 1
                if emitted == n_batches:
                    break
        # drop_last=False: the final partial batch (counted by __len__,
        # so resume offsets stay consistent with the emitted stream)
        if buf and not self.drop_last and emitted < n_batches and emitted >= start:
            batch = collate(buf)
            yield self.post_batch_fn(batch) if self.post_batch_fn else batch


def make_native_post_batch(img_size: int):
    """Fused native composite+warp+normalize on collated raw items (the
    grain counterpart of ``pipeline.make_native_collate``): one C++ call
    per image role preprocesses the whole batch."""
    from nope_tpu_torch import native

    def post(batch):
        out = {}
        for role in ("query", "reference"):
            out[role] = native.preprocess_batch(
                np.ascontiguousarray(batch[f"{role}_rgba"]),
                np.ascontiguousarray(batch[f"{role}_M"]),
                img_size,
            )
        for k, v in batch.items():
            if not k.endswith(("_rgba", "_M")):
                out[k] = v
        return out

    return post
