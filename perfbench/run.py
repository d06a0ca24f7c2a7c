#!/usr/bin/env python3
"""The benchmark of ``nope_tpu_torch`` on NVIDIA GPUs.

    python3 perfbench/run.py --workload vae_base.eval_full --seed 7 --seconds 36 --trace 0

From the root of a checkout that holds the program.  One run of one cell
of ``BENCHMARK.json``: set-up from the seed (weights drawn on the card,
inputs on the host, every shape warmed), a window of ``--seconds``
through the program's own entry point, then a sample of the window's
answers judged against the plain reference.  The last line of standard
output is one JSON object; the numbers compared and their limits close
standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.

Exits non-zero, printing no result, without enough CUDA devices, or if
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

#: top-level modules no run may load: JAX, its libraries and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "nope_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from perfbench import harness

    bench = harness.spec()
    chips = harness.cell_files(bench, args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                              T_START, bench)
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
