"""Input pipeline (``nope_tpu/data/pipeline.py``): batching, shuffling,
prefetching, multi-dataset combining.

A lightweight thread-prefetched loader feeding numpy batches (Pillow,
cv2, zlib and the native warp release the GIL, so threads parallelise
the hot path without worker-process serialisation), and a combiner
that yields one batch per dataset each step, cycling shorter datasets:
the semantics of the reference's ``DataLoader`` + Lightning
``CombinedLoader(mode="max_size_cycle")`` stack
(``src/utils/dataloader.py:7-19``), and the JAX package's loader to the
batch; :func:`device_prefetch` overlaps the host-to-device copies with
the train step.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np
import torch


def collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class DataLoader:
    """Shuffling, batching, thread-prefetching loader over a map-style
    dataset (``len`` + ``__getitem__`` → dict of numpy arrays)."""

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 2,
        collate_fn=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.collate_fn = collate_fn or collate
        self._epoch = 0
        self._seed = seed
        self._start_batch = 0  # consumed by the next __iter__ (resume)

    def __len__(self) -> int:
        n = len(self.dataset)
        count = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        if count == 0:
            raise ValueError(
                f"dataset of {n} items yields 0 batches at batch_size="
                f"{self.batch_size} (drop_last={self.drop_last})"
            )
        return count

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(idx)
        return idx

    def set_state(self, epoch: int, batch_offset: int = 0) -> None:
        """Position the loader mid-stream for deterministic resume: the
        next ``__iter__`` replays epoch ``epoch``'s shuffle order but
        starts ``batch_offset`` batches in — skipped batches are sliced
        off the index list, never fetched.  Beats the reference's
        Lightning resume (train.py:142-149), which restarts the sampler
        stream at epoch 0."""
        self._epoch = int(epoch)
        self._start_batch = int(batch_offset)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        # advance the dataset's own deterministic sampling stream (e.g.
        # reference-image draws) in lock-step with the shuffle epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        n_batches = len(self)
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(n_batches)
        ]
        if self._start_batch:  # one-shot mid-epoch resume (set_state)
            batches = batches[self._start_batch :]
            self._start_batch = 0

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def offer(item) -> bool:
            """Bounded put that can't deadlock when the consumer
            abandons the iterator: poll the stop event while blocked."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            try:  # consumer gone; best effort, never block
                out_q.put_nowait(item)
            except queue.Full:
                pass
            return False

        def producer():
            try:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, batch_idx))
                        if not offer(self.collate_fn(items)):
                            return
            except Exception as e:  # surface worker errors to the consumer
                offer(e)
            finally:
                offer(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


class CombinedLoader:
    """``max_size_cycle``: each step yields ``{name: batch}`` with one
    batch per dataset; shorter loaders restart until the longest is
    exhausted (Lightning CombinedLoader semantics the reference trains
    with)."""

    def __init__(self, loaders: Dict[str, DataLoader]):
        if not loaders:
            raise ValueError("no loaders")
        self.loaders = loaders
        self._start_step = 0  # consumed by the next __iter__ (resume)

    def __len__(self) -> int:
        return max(len(l) for l in self.loaders.values())

    def set_state(self, global_step: int) -> None:
        """Position every member loader as an uninterrupted run would be
        after ``global_step`` combined steps.

        Semantics mirrored from ``__iter__``: each combined epoch of
        ``M = len(self)`` steps starts FRESH iterators for all loaders,
        and a loader of length ``L`` wraps (re-iterates, bumping its
        shuffle epoch) every ``L`` steps — so per combined epoch its
        epoch counter advances ``ceil(M / L)`` times.  At combined step
        ``k`` into epoch ``E`` it is therefore ``k % L`` batches into
        its own epoch ``E * ceil(M/L) + k // L``.  The next ``__iter__``
        yields only the epoch's remaining ``M - k`` steps."""
        M = len(self)
        E, k = divmod(int(global_step), M)
        for loader in self.loaders.values():
            L = len(loader)
            wraps_per_epoch = -(-M // L)  # ceil
            loader.set_state(E * wraps_per_epoch + k // L, k % L)
        self._start_step = k

    def __iter__(self) -> Iterator[Dict[str, Dict[str, np.ndarray]]]:
        iters = {name: iter(l) for name, l in self.loaders.items()}
        start = self._start_step
        self._start_step = 0
        for _ in range(len(self) - start):
            step: Dict[str, Dict[str, np.ndarray]] = {}
            for name in self.loaders:
                try:
                    step[name] = next(iters[name])
                except StopIteration:
                    iters[name] = iter(self.loaders[name])
                    step[name] = next(iters[name])
            yield step


class ConcatDataset:
    """torch.utils.data.ConcatDataset equivalent (used by the
    ``bop_texture`` multi-dataset group, ``train.py:73-98``)."""

    def __init__(self, datasets: List[Any]):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self._offsets[d])]


def device_prefetch(iterator: Iterator, device: torch.device, depth: int = 2) -> Iterator:
    """Overlap host-to-device copies with compute
    (``nope_tpu/data/pipeline.py:207-229``): keep ``depth`` batches in
    flight on ``device``.  Each batch is a (nested) dict of numpy arrays;
    every array goes through pinned host memory and a ``non_blocking``
    copy on a side stream, and the consumer's stream waits for that copy
    before it reads the batch.  dtypes are kept: a uint8 wire stays uint8
    until the step normalises it on the device.  On the CPU the arrays
    become tensors that share their memory."""
    device = torch.device(device)
    buf: "collections.deque" = collections.deque()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch):
        if isinstance(batch, dict):
            return {k: put(v) for k, v in batch.items()}
        t = torch.as_tensor(np.ascontiguousarray(batch))
        if stream is None:
            return t.to(device)
        with torch.cuda.stream(stream):
            return t.pin_memory().to(device, non_blocking=True)

    def ready(batch):
        if stream is not None:
            torch.cuda.current_stream(device).wait_stream(stream)
            for t in _leaves(batch):
                t.record_stream(torch.cuda.current_stream(device))
        return batch

    for batch in iterator:
        buf.append(put(batch))
        if len(buf) > depth:
            yield ready(buf.popleft())
    while buf:
        yield ready(buf.popleft())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def make_native_collate(img_size: int):
    """Batch collate for raw RGBA+homography items
    (``ShapeNetDataset.raw_item``): one fused native
    composite+warp+normalize call per image role."""
    from nope_tpu_torch import native

    def native_collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for role in ("query", "reference"):
            rgba = np.stack([it[f"{role}_rgba"] for it in items])
            Ms = np.stack([it[f"{role}_M"] for it in items])
            out[role] = native.preprocess_batch(rgba, Ms, img_size)
        for key in items[0]:
            if not key.endswith(("_rgba", "_M")):
                out[key] = np.stack([it[key] for it in items])
        return out

    return native_collate
