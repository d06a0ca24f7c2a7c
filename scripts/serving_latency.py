#!/usr/bin/env python3
"""Registration and ``estimate`` latency of one checkout of the port, as
medians over many calls, for comparing two checkouts on one card.

    python3 scripts/serving_latency.py [--root DIR] [--reps 15]

On one CUDA GPU.  Imports ``nope_tpu_torch`` from the checkout at DIR
(default: this one) and builds the flagship task as ``chip_smoke.py``
does (seeded random weights, full width).  Each metric is timed call by
call (host clock around a call that ends in a synchronise) after two
warm-up calls: bf16 registration at N=26 and N=341, bf16 ``estimate`` at
B=8 and B=64 against the N=26 bank.  Prints the median, the quartiles
and the minimum of each.  Run the two checkouts in alternating processes
(A, B, B, A) to compare them.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def timed(fn, reps: int) -> list[float]:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path, default=HERE, help="checkout whose nope_tpu_torch is timed")
    parser.add_argument("--reps", type=int, default=15)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("serving_latency: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke  # the checkout's own, for its flagship configuration
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.serving import PoseEstimator
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line(), f"root={args.root}")
    task = build_task(chip_smoke.flagship_config(), dev, torch.Generator().manual_seed(0))
    bf16 = PoseConditionalTask(task.unet, task.vae, dataclasses.replace(task.config, half_precision_eval=True))
    rng = np.random.default_rng(0)
    ref = rng.uniform(-1, 1, (chip_smoke.IMAGE, chip_smoke.IMAGE, 3)).astype(np.float32)
    rows = []
    for n in (chip_smoke.FAST_N, chip_smoke.FULL_N):
        est = PoseEstimator(bf16, fast_evaluation=(n == chip_smoke.FAST_N))
        rows.append((f"register_object bfloat16 N={n}", timed(lambda: est.register_object("o", ref), args.reps)))
    est = PoseEstimator(bf16, fast_evaluation=True)
    est.register_object("o", ref)
    for b in (8, 64):
        q = rng.integers(0, 256, (b, chip_smoke.IMAGE, chip_smoke.IMAGE, 3), dtype=np.uint8)
        rows.append((f"estimate bfloat16 N={chip_smoke.FAST_N} B={b}", timed(lambda: est.estimate("o", q), args.reps)))
    for label, ms in rows:
        q1, med, q3 = statistics.quantiles(ms, n=4)
        print(f"  {label:<34} median {med:8.3f} ms  quartiles {q1:8.3f} {q3:8.3f}  min {min(ms):8.3f}  "
              f"({len(ms)} calls)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
