#!/usr/bin/env python3
"""The parallel paths on the GPUs of one host, one rank a GPU, under NCCL::

    torchrun --nproc-per-node 4 scripts/parallel_scaling.py [--steps 8]
    torchrun --nproc-per-node 1 scripts/parallel_scaling.py   # the same on one card

Every rank builds the flagship task (seeded random weights, full width,
``chip_smoke.flagship_config``; TF32 off, cuDNN deterministic) and, on
a mesh of all ranks:

1. the bf16 data-parallel train step at 16 pairs a rank (a global batch
   of 16 x ranks), replicated and then ZeRO-1, each from the same start:
   CUDA events around each of ``--steps`` steps after two warm-ups; after
   them every rank must hold the same weights (a checksum gathered), and
   the ZeRO-1 weights must be the replicated run's;
2. the streaming eval, bf16, B=16: the fast grid (N=26) over a
   (ranks / 2, 2) mesh in chunks of 13, the full grid (N=341, which no
   even template axis divides) over a (ranks, 1) mesh in chunks of 31,
   timed the same way; rank 0 holds each against ``retrieve_streaming``
   in one process (the scores within rel 1e-2, the top-1 equal where
   its margin exceeds 1e-2 of the row's largest score, as
   ``chip_smoke.py`` phase 6 does).

Rank 0 prints one JSON line: the card's name and power limit, the ranks,
each path's median and quartiles in ms, pairs/s and images/s across the
ranks, and the checks.  Run it with 1 and with N ranks in one call to
read the scaling.  ``--device cpu --dist-backend gloo --tiny`` rehearses
it on CPU processes at a tiny width (host clock, no device metric).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
TINY = ["model.img_size=32", "model.u_net.u_net_dim=16", "model.u_net.dim_mults=1,2",
        "model.encoder.block_out_channels=8,8,8,8", "model.encoder.layers_per_block=1", "model.encoder.norm_groups=4"]
PAIRS, QUERIES, FAST_CHUNK, CHUNK = 16, 16, 13, 31


def timed(fn, steps: int, cuda: bool) -> list:
    """ms of each of ``steps`` calls after two warm-ups: CUDA events on the
    card, the host clock on the CPU."""
    for _ in range(2):
        fn()
    out = []
    for _ in range(steps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
    return out


def summary(ms: list) -> dict:
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"median_ms": float(med), "quartiles_ms": [float(q1), float(q3)]}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--device", default="cuda", help="cuda (cuda:LOCAL_RANK) or cpu")
    parser.add_argument("--dist-backend", default=None)
    parser.add_argument("--tiny", action="store_true", help="a tiny width (CPU rehearsal)")
    args = parser.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.geometry import so3_grid
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.ops import _build
    from nope_tpu_torch.parallel.eval import make_sharded_streaming_eval_fn
    from nope_tpu_torch.parallel.mesh import (
        all_gather_host,
        create_mesh,
        initialize_distributed,
        process_barrier,
        process_count,
        process_index,
        shard_batch,
    )
    from nope_tpu_torch.parallel.zero import zero1_state_shardings
    from nope_tpu_torch.training import optim, train_state

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("parallel_scaling: no CUDA device (--device cpu for a rehearsal)", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # bitwise-repeatable cuDNN, so the ZeRO-1 run can equal the replicated one
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    device = initialize_distributed(backend=args.dist_backend, device=args.device)
    rank, world = process_index(), process_count()
    cuda = device.type == "cuda"
    if args.tiny:
        cs.IMAGE, cs.LATENT = 32, 4
    if cuda:
        if rank == 0:
            _build.build()  # once, before the other ranks load it
        process_barrier("built")
        _build.library()
    cfg = load_config(None, TINY if args.tiny else []).model
    mesh = create_mesh()
    batch = shard_batch({"ds": cs.train_pairs(torch, PAIRS * world, 98)}, mesh)
    out = {"ranks": world, "backend": torch.distributed.get_backend() if world > 1 else None,
           "pairs_per_rank": PAIRS}

    def checksum(module) -> float:
        return float(sum(p.detach().double().sum() for p in module.parameters()))

    # 1. the data-parallel step, replicated then ZeRO-1, from the same seeded start
    sums = {}
    for name in ("replicated", "zero1"):
        task = build_task(cfg, device, torch.Generator().manual_seed(0))
        state = train_state.create_train_state(task, optim.make_optimizer(task.unet.parameters(), warm_up_steps=0))
        shardings = zero1_state_shardings(state, mesh) if name == "zero1" else None
        step = train_state.make_train_step(task, half_precision=True, state_shardings=shardings, mesh=mesh)
        ms = timed(lambda: step(state, batch), args.steps, cuda)
        out[f"{name}_step"] = {**summary(ms), "pairs_per_s": PAIRS * world * 1e3 / float(np.median(ms))}
        sums[name] = checksum(task.unet)
        gathered = all_gather_host(np.asarray([sums[name]])).reshape(-1) if world > 1 else [sums[name]]
        out[f"{name}_weights_equal_on_every_rank"] = bool(np.all(np.asarray(gathered) == gathered[0]))
        del task, state, step
        if cuda:
            torch.cuda.empty_cache()
    out["zero1_equals_replicated"] = sums["zero1"] == sums["replicated"]

    # 2. the streaming sweep: the fast grid split over a template axis of 2
    # (26 = 2 x 13; the level-2 grids hold 2 mod 4 poses), the full grid
    # over the data axis (341 = 11 x 31 splits over no even axis)
    half = build_task(cfg, device, torch.Generator().manual_seed(0)).half()
    fast = so3_grid.get_obj_poses_from_template_level(2, "all")[so3_grid.load_index_level0_in_level2("upper")]
    full = so3_grid.get_obj_poses_from_template_level(2, "upper")
    t = 2 if world % 2 == 0 else 1
    for name, grid, shape, chunk in (("fast", fast, (world // t, t), FAST_CHUNK), ("full", full, (world, 1), CHUNK)):
        eb = cs.eval_batch(torch, grid[:, :3, :3].astype(np.float32), QUERIES, 99)
        run = make_sharded_streaming_eval_fn(half, create_mesh(*shape), chunk_size=chunk)
        got = run(eb["reference"], eb["query"], eb["all_relativeR"])
        ms = timed(lambda: run(eb["reference"], eb["query"], eb["all_relativeR"]), max(2, args.steps // 2), cuda)
        out[f"sweep_{name}"] = {**summary(ms), "mesh": list(shape), "queries": QUERIES, "templates": len(grid),
                                "images_per_s": QUERIES * 1e3 / float(np.median(ms))}
        if rank == 0:
            db = cs.on_device(torch, eb, device, torch.bfloat16)
            want = half.retrieve_streaming(db["query"], db["reference"], db["all_relativeR"], chunk)
            rel, decided, same, top1 = cs._topk_check(torch, *got, *want)
            out[f"sweep_{name}"]["check"] = {"rel": rel, "decided_rows": decided, "top1_equal_rows": same,
                                              "ok": rel <= cs.BF16_SIM_RTOL and top1}
    process_barrier("done")
    if rank == 0:
        out["card"] = cs.nvidia_smi_line() if cuda else "CPU (rehearsal; no device metric)"
        print(json.dumps(out))
    if world > 1:
        torch.distributed.destroy_process_group()
    ok = (out["replicated_weights_equal_on_every_rank"] and out["zero1_weights_equal_on_every_rank"]
          and out["zero1_equals_replicated"]
          and (rank != 0 or all(out[f"sweep_{n}"]["check"]["ok"] for n in ("fast", "full"))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
