#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process.

    python3 perfbench/calibrate.py --workload vae_base.eval_full --seeds 12 --seconds 5 --control-seeds 4

For each of ``--seeds`` seeds (from ``--first-seed``): set-up and a short
window at the cell's own load, then the sample of answers a run judges,
against the reference (the program's reading); for the first
``--control-seeds`` also the control (the reference one precision lower,
in the program's place) on the same inputs.  With ``--faults N``, each
planted fault of the cell's generator (``tests/faults/<generator
module>.py``) is planted in the program in turn and read on N seeds.
Prints one JSON line a seed (and a fault) and a summary: each number's
largest program reading and smallest control and fault readings.  The
benchmark's own runs never run the control nor plant a fault.
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
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--control-seeds", type=int, default=4)
    parser.add_argument("--faults", type=int, default=0, help="seeds on which each planted fault is read")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from perfbench import harness

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.spec()
    program, control = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        _, run, outcome, _ = harness.drive(args.workload, seed, args.seconds, False, device, time.perf_counter(),
                                           bench)
        side = harness.side(run.cfg, "reference", seed, device)
        line = {"seed": seed, "program": outcome.check(side), "metrics": outcome.metrics, "failed": outcome.failed}
        if i < args.control_seeds:
            line["control"] = outcome.check(side, harness.side(run.cfg, "control", seed, device))
        del side
        harness.free()
        print(json.dumps(line), flush=True)
        for name, v in line["program"].items():
            program[name] = max(program.get(name, 0.0), v)
        for name, v in line.get("control", {}).items():
            control[name] = min(control.get(name, float("inf")), v)
    faults = {}
    if args.faults:
        import pytest

        from perfbench.tests import toy

        for fault in toy.faults(args.workload):
            for i in range(args.faults):
                seed = args.first_seed + 7919 * i
                patch = pytest.MonkeyPatch()
                fault(patch)
                try:
                    _, run, outcome, _ = harness.drive(args.workload, seed, args.seconds, False, device,
                                                       time.perf_counter(), bench)
                    readings = outcome.check(harness.side(run.cfg, "reference", seed, device))
                finally:
                    patch.undo()
                del run, outcome
                harness.free()
                print(json.dumps({"seed": seed, "fault": fault.__name__, "readings": readings}), flush=True)
                least = faults.setdefault(fault.__name__, {})
                for name, v in readings.items():
                    least[name] = min(least.get(name, float("inf")), v)
    print(json.dumps({"workload": args.workload, "program_max": program, "control_min": control,
                      "fault_min": faults}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
