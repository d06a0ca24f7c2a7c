#!/usr/bin/env python3
"""K1 and K2 on the card: each op timed both ways, then each kernel
timed with the plan its wrapper picks beside other plans.

    python3 scripts/k1_k2_plans.py                 # op times, then the plan sweep
    python3 scripts/k1_k2_plans.py --package DIR   # op times of the nope_tpu_torch in DIR
    python3 scripts/k1_k2_plans.py [--package DIR] --dump FILE   # K1's C = 4 outputs only
    python3 scripts/k1_k2_plans.py --compare FILE FILE           # bitwise equal?

On one CUDA GPU, from the root of a checkout.  Op times are those of
``reference_similarity`` (K1) at B = 64 and 8 queries against N = 341
templates, at C = 4 and, for the template encoder's descriptors, C = 8
(also B = 64 against a bank of 26 per query), and
``linear_attention_inner`` (K2) at 26 and 341 items times
1024 tokens, in bfloat16 and float32, measured two ways: back-to-back
calls with the host in the loop (``chip_smoke.cuda_ms``, 20 calls after
3) and on the device alone (``chip_smoke.device_ms``, the stream held by
a sleep while the host queues 50 calls).  ``--package`` times another
checkout's ops (such as the parent commit's) with this script's clocks;
it has no plans to sweep.  The sweep times device alone, over inputs
that stay in L2 where they fit: K2 with chunk lengths of 64, 96, 128,
256 tokens and one chunk, at 3, 26, 341 items times 1024, 256, 64, 16
tokens; K1 with 1, 2, 4, 8 and 16 pixel splits at the serving shapes.
Correctness is ``chip_smoke.py``'s phase 2.  ``--dump`` saves K1's
outputs at C = 4 (both dtypes, the K1_SHAPES below, seeded inputs drawn
on the host) and ``--compare`` holds two dumps bitwise equal: run with
``--package`` over another checkout, the same script shows that a change
to K1 left its C = 4 results as they were.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

REPS = 50
K2_ITEMS, K2_TOKENS = (3, 26, 341), (1024, 256, 64, 16)
# (B, N, bank lead): the serving requests, the batched bank, a ragged B
K1_SHAPES = ((64, 341, 1), (8, 341, 1), (8, 26, 1), (64, 26, 1), (8, 26, 8), (3, 341, 1))


def device_ms(fn) -> float:
    return chip_smoke.device_ms(torch, fn, REPS)


def op_times(sim, la, dev, gen) -> None:
    """The public ops, with the host in the loop and on the device alone."""
    print(f"op times (ms; {chip_smoke.nvidia_smi_line()})")
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for b, n, lead, c in ((64, 341, 1, 4), (8, 341, 1, 4), (64, 341, 1, 8), (64, 26, 64, 8)):
            q = torch.randn(b, 32, 32, c, generator=gen).to(dev, dtype)
            bank = torch.randn(lead, n, 32, 32, c, generator=gen).to(dev, dtype)
            host = chip_smoke.cuda_ms(torch, lambda: sim.reference_similarity(q, bank), 20, warmup=3)
            alone = device_ms(lambda: sim.reference_similarity(q, bank))
            print(f"  K1 {dn:<8} B={b:<3} N={n:<4} lead {lead:<2} C={c} with host {host:.4f} device alone "
                  f"{alone:.4f}", flush=True)
        for items, n in ((26, 1024), (341, 1024)):
            qkv = (2 * torch.randn(items, n, 384, generator=gen)).to(dev, dtype)
            host = chip_smoke.cuda_ms(torch, lambda: la.linear_attention_inner(qkv, 4, 32), 20, warmup=3)
            alone = device_ms(lambda: la.linear_attention_inner(qkv, 4, 32))
            print(f"  K2 {dn:<8} items={items:<3} n={n:<4} with host {host:.4f} device alone {alone:.4f}", flush=True)


def k2_run(la, qkv, plan):
    out = torch.empty(*qkv.shape[:2], 128, dtype=qkv.dtype, device=qkv.device)
    la._launch(qkv, out, plan)
    return out


def k1_run(sim, q, bank, plan):
    out = torch.empty(q.shape[0], bank.shape[1], dtype=torch.float32, device=q.device)
    sim._launch(q, bank, out, plan)
    return out


def plan_sweep(sim, la, dev, gen, sms) -> None:
    print(f"plan sweep (device time alone, mean of {REPS}; {chip_smoke.nvidia_smi_line()})")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b in K2_ITEMS:
            for n in K2_TOKENS:
                qkv = (2 * torch.randn(b, n, 384, generator=gen)).to(dev, dtype)
                picked = la.attention_plan(b, n, sms, dtype == torch.float32)
                plans = {la.AttentionPlan(c, -(-n // c)) for c in (64, 96, 128, 256, n) if c <= n} | {picked}
                bnd = chip_smoke.bound(f32_ops=float(b * n * 4) * (4 * 32 * 32 + 8 * 32),
                                       nbytes=float(b * n * 512) * qkv.element_size())
                row = [f"{p.chunk_len}x{p.chunks}{'*' if p == picked else ''} "
                       f"{device_ms(lambda: k2_run(la, qkv, p)):.4f}" for p in sorted(plans)]
                print(f"  K2 {dn:<8} B={b:<3} n={n:<4} bound {bnd[0]:.4f} ms; chunk_len x chunks ms: "
                      + ", ".join(row), flush=True)
        for b, n, lead in K1_SHAPES:
            q = torch.randn(b, 32, 32, 4, generator=gen).to(dev, dtype)
            bank = torch.randn(lead, n, 32, 32, 4, generator=gen).to(dev, dtype)
            picked = sim.similarity_plan(b, n, 1024, sim._batched(q, bank), sms)
            plans = {sim.SimilarityPlan(-(-16 // s) * 64, s) for s in (1, 2, 4, 8, 16)} | {picked}
            bnd = chip_smoke.bound(f32_ops=float(b * n * 1024) * 15,
                                   nbytes=float(q.numel() + bank.numel()) * q.element_size() + 4 * b * n)
            row = [f"{p.splits}{'*' if p == picked else ''} {device_ms(lambda: k1_run(sim, q, bank, p)):.4f}"
                   for p in sorted(plans, key=lambda p: p.splits)]
            print(f"  K1 {dn:<8} B={b:<2} N={n:<3} lead {lead} bound {bnd[0]:.4f} ms; splits ms: " + ", ".join(row),
                  flush=True)


def dump(sim, dev, path) -> None:
    gen, outs = torch.Generator().manual_seed(5), {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, lead in K1_SHAPES:
            q = torch.randn(b, 32, 32, 4, generator=gen).to(dev, dtype)
            bank = torch.randn(lead, n, 32, 32, 4, generator=gen).to(dev, dtype)
            outs[f"{dtype} {b} {n} {lead}"] = sim.reference_similarity(q, bank).cpu()
    torch.save(outs, path)
    print(f"K1 C=4 outputs at {len(outs)} shapes -> {path}")


def compare(a, b) -> int:
    x, y = torch.load(a), torch.load(b)
    same = [k for k in x if torch.equal(x[k], y[k])]
    print(f"K1 C=4: {len(same)} of {len(x)} outputs bitwise equal ({a} vs {b})"
          + "".join(f"\n  differs: {k} max|d| {float((x[k] - y[k]).abs().max()):.3e}" for k in x if k not in same))
    return 0 if set(x) == set(y) and len(same) == len(x) else 1


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--package", type=Path, help="time the ops of the nope_tpu_torch in this checkout")
    parser.add_argument("--dump", type=Path, help="save K1's C = 4 outputs here and stop")
    parser.add_argument("--compare", type=Path, nargs=2, help="two dumps: exit 0 if bitwise equal")
    args = parser.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("k1_k2_plans: no CUDA device", file=sys.stderr)
        return 2
    if args.package is not None:
        sys.path.insert(0, str(args.package.resolve()))
    from nope_tpu_torch.ops import _build
    from nope_tpu_torch.ops import linear_attention as la
    from nope_tpu_torch.ops import similarity as sim

    dev = torch.device("cuda", 0)
    path, nvcc_s = _build.build()
    print(f"{path}: build {nvcc_s:.2f} s")
    if args.dump:
        dump(sim, dev, args.dump)
        return 0
    gen = torch.Generator().manual_seed(3)
    op_times(sim, la, dev, gen)
    if args.package is None:
        plan_sweep(sim, la, dev, gen, _build.sm_count(dev))
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
