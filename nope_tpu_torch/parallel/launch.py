"""A group of ranks started as fresh processes on this host.

``Ranks(fn, world, args)`` starts ``world`` processes (the ``spawn``
method: nothing of the parent's state is inherited) that each call
``fn(rank, world, init_method, *args)``, where ``init_method`` is a
``file://`` store private to the group: ``fn`` passes it to
``parallel.mesh.initialize_distributed``.  ``join()`` returns the ranks'
return values in rank order.  A rank that raises, dies or outlives the
timeout fails the whole group: the others are killed and ``join``
raises, with the failed rank's traceback.  ``fn`` must be a module-level
function and its arguments and result picklable.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence


def _rank_main(fn: Callable, rank: int, world: int, init_method: str, args: Sequence, results) -> None:
    import torch.distributed as dist

    try:
        value = fn(rank, world, init_method, *args)
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # by value: the queue's own pickler would pass tensors as shared
    # memory, whose handles die with this process
    results.put((rank, None, pickle.dumps(value)))


class Ranks:
    """``world`` processes running ``fn``, started at construction."""

    def __init__(self, fn: Callable, world: int, args: Sequence = (), timeout: float = 600.0):
        self.world, self.timeout = world, timeout
        self._dir = tempfile.mkdtemp(prefix="nope_ranks_")
        init_method = "file://" + os.path.join(self._dir, "store")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, args=(fn, r, world, init_method, tuple(args), self._results))
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._deadline = time.monotonic() + timeout

    def join(self) -> List[Any]:
        out = {}
        try:
            while len(out) < self.world:
                remaining = self._deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(self.world)) - set(out))} did not finish "
                                       f"within {self.timeout:.0f} s")
                try:
                    rank, error, value = self._results.get(timeout=min(remaining, 1.0))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"ranks exited without a result (rank, exit code): {dead}")
                    continue
                if error is not None:
                    raise RuntimeError(f"rank {rank} of {self.world} failed:\n{error}")
                out[rank] = pickle.loads(value)
            for p in self._procs:
                p.join(max(self._deadline - time.monotonic(), 1.0))
            codes = [p.exitcode for p in self._procs]
            if any(c != 0 for c in codes):
                raise RuntimeError(f"ranks returned but exited with codes {codes}")
            return [out[r] for r in range(self.world)]
        finally:
            for p in self._procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            shutil.rmtree(self._dir, ignore_errors=True)


def run_ranks(fn: Callable, world: int, args: Sequence = (), timeout: float = 600.0) -> List[Any]:
    """Start ``world`` ranks of ``fn`` and return their results (see :class:`Ranks`)."""
    return Ranks(fn, world, args, timeout).join()
