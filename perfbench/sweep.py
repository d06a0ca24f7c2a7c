#!/usr/bin/env python3
"""The rates a serving cell's mix can offer, found once by a sweep.

    python3 perfbench/sweep.py --workload vae_base.serve_mixed --rates 24,32,36,40,44 --seconds 15

For each rate, in one process: the cell's set-up and an open-loop window
at that rate (no reference check).  Prints per rate the calls served a
second, the p50 and p95 of estimates and registrations, the mean wait in
the window's first and last quarters and how long the queue took to
drain after the window closed: past the knee the wait grows all through
the window.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=15.0)
    parser.add_argument("--seed", type=int, default=2_150_000_003)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from perfbench import harness

    bench = harness.spec()
    mix = harness.load_json(harness.cell_files(bench, args.workload)["mix"])
    for rate in (float(r) for r in args.rates.split(",")):
        _, run, outcome, record = harness.drive(args.workload, args.seed, args.seconds, False,
                                                torch.device("cuda"), time.perf_counter(), bench,
                                                mix=dict(mix, rate=rate))
        waits = np.asarray(record["window"]["queue_wait_ms"])
        quarter = max(len(waits) // 4, 1)
        line = {"rate": rate, "served_per_s": record["window"]["calls"] / record["window"]["seconds"],
                "drain_s": record["window"]["seconds"] - args.seconds,
                "wait_first_quarter_ms": float(waits[:quarter].mean()),
                "wait_last_quarter_ms": float(waits[-quarter:].mean()), **outcome.metrics}
        print(json.dumps(line), flush=True)
        harness.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
