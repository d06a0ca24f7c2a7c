#!/usr/bin/env python3
"""K3's tensor-core routes (bf16, and float32 in 3xTF32) at each tile
height their conv kernels take, and in bf16 each epilogue and ring depth;
then bf16's fused GroupNorm against the chain, and its clusters'
weight multicast on and off.

    python3 scripts/k3_tiles.py [--dtype bfloat16|float32] [--batch B ...] [--ring N ...]
                                [--sweep tiles|fused ...]
    python3 scripts/k3_tiles.py --plans   # the plan table alone, on any host

On one CUDA GPU, from the root of a checkout.  For every ResnetBlock
shape of the flagship U-Net (recorded as ``chip_smoke.py`` records them)
at B = 3, 26, 341 and 3,328 (the fast protocol's eval call; bf16 only),
the block runs with each tile the route's kernel takes
(``fused_resnet.TENSOR_CORE_ROUTES[dtype].tiles``; in bf16 with the
staged and the register epilogue; the shortest tile splits K as
``conv_plan`` splits it), beside the tile ``conv_plan`` picks.  The bf16
kernel sizes its own ring (the deepest that fits, at most 5 K-slices);
each ``--ring N`` builds the kernels once more with it cut to at most N
(``nvcc -DNOPE_CONV_RING=N``) and sweeps bf16 again.  The blocks of
``chip_smoke.K3_GROUP_SHAPES`` (GroupNorm widths beside the flagship's)
run too, outside the sums.  Each run is checked against the plain
version (``chip_smoke.TOL``: 1e-2 bf16, 1e-4 float32), two launches
bitwise equal, and timed on the device alone: the stream is held by a
sleep while the host queues the launches, so host time does not enter.
The last lines sum each candidate over the 22 blocks of one U-Net
forward per batch, beside ``conv_plan``'s choice.  Both dtypes by
default.

``--sweep fused`` (bf16, B = 26, 341 and 3,328 unless ``--batch``) runs
each block as ``conv_plan`` plans it ("plan": where a conv fuses,
GroupNorm in its epilogue), as the chain (``conv_plan(..., fuse=False)``:
the same tiles, ``gn_finalize`` and ``gn_silu``) and, where a sample's
tiles form a cluster, with the weight multicast of its pairs flipped; it
holds plan and chain bitwise equal, each against the plain version and
repeatable, and times them beside ``F.conv2d`` over the block's convs.
Both sweeps by default.  First it prints ``conv_plan``'s plan of both
convs of every flagship block at B = 3, 26, 341, 1,984 and 3,328 and how
many clusters of 1, 2, 4 and 8 CTAs the card holds at once.
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nope_tpu_torch.models.factory import build_task  # noqa: E402
from nope_tpu_torch.ops import _build  # noqa: E402
from nope_tpu_torch.ops import fused_resnet as fr  # noqa: E402
from nope_tpu_torch.ops import linear_attention as la  # noqa: E402

BATCHES = {"bfloat16": chip_smoke.K3_BATCHES + (chip_smoke.EVAL_ITEMS[1],), "float32": chip_smoke.K3_BATCHES}


def candidates(route):
    """(label, route restricted to one tile and, in bf16, one epilogue)
    for every tile of ``route``; "s" marks the staged epilogue, "r" the
    register one (which groups it cannot take still stage)."""
    for tile in route.tiles:
        if not route.boxed:
            yield f"{tile}", route._replace(tiles=(tile,))
            continue
        for staged in (True, False):
            yield f"{tile}{'s' if staged else 'r'}", route._replace(tiles=(tile,),
                                                                    staged_below=1 << 30 if staged else 0)


def forced_plan(one):
    """``conv_plan`` with the route cut to one tile and epilogue."""
    plan = fr.conv_plan

    def forced(m, hw, c_out, k_slices, sms, route, width=None, groups=None):
        return plan(m, hw, c_out, k_slices, sms, one, width, groups)

    return forced


def tile_label(plan, route):
    """A plan's candidate label: its tile, and in bf16 its epilogue."""
    return f"{plan.tile}{('s' if plan.staged else 'r') if route.boxed else ''}"


def flipped_multicast(plan):
    """``conv_plan`` with a fused cluster's weight multicast (in pairs)
    flipped."""

    def forced(*args, **kwargs):
        p = plan(*args, **kwargs)
        return p._replace(multicast=1 - p.multicast) if cluster_fused(p, args[1]) else p

    return forced


def chained(plan):
    """``conv_plan`` that keeps the chain: the same tiles, no fused epilogue."""
    return lambda *args, **kwargs: plan(*args, **{**kwargs, "fuse": False})


def cluster_fused(p, hw):
    """Whether plan ``p`` is a cluster of tiles of one sample, fused, that
    can multicast in pairs."""
    return p.fused and p.bm < hw and p.cluster % 2 == 0


PLAN_BATCHES = (3, chip_smoke.FAST_N, chip_smoke.FULL_N) + chip_smoke.EVAL_ITEMS


def plan_table(shapes, sms):
    """Both convs' plans of every flagship block shape at PLAN_BATCHES."""
    route = fr.TENSOR_CORE_ROUTES[torch.bfloat16]
    print(f"conv_plan, bf16, {sms} SMs: (bm, splits, staged, cluster, fused, multicast) of conv 1 / conv 2")
    for batch in PLAN_BATCHES:
        for h, w, cin, co, res, emb, groups in shapes:
            plans = [fr.conv_plan(batch * h * w, h * w, co, 9 * c // route.slice_k, sms, route, w, groups)
                     for c in (cin, co)]
            print(f"  B={batch:<4} {h:>2}x{w:<2} {cin:>4}->{co:<4} " + " / ".join(
                f"({p.bm}, {p.splits}, {p.staged}, {p.cluster}, {p.fused}, {p.multicast})" for p in plans))


def fused_sweep(shapes, k3_calls, batches, dev, gen):
    """Each block as planned, as the chain and with a fused cluster's
    multicast flipped: held and timed (device alone) beside F.conv2d."""
    import torch.nn.functional as F

    plan = fr.conv_plan
    variants = (("plan", plan), ("chain", chained(plan)), ("mc flipped", flipped_multicast(plan)))
    optional = {"mc flipped": cluster_fused}
    for batch in batches:
        reps = 20 if batch <= 341 else 3
        totals, stages = {}, {}
        for shape in shapes:
            h, w, cin, co, groups = *shape[:4], shape[6]
            x, emb, params = chip_smoke.k3_inputs(torch, shape, batch, dev, torch.bfloat16, gen)
            want = fr.resnet_block_plain(x.float(), None if emb is None else emb.float(),
                                         {k: v.float() for k, v in params.items()}, groups)
            outs, times, ms_of = {}, [], {}
            conv1 = (batch * h * w, h * w, co, 9 * cin // 64, _build.sm_count(dev), fr.TENSOR_CORE_ROUTES[torch.bfloat16],
                     w, groups)  # the first conv's conv_plan arguments
            for label, forced in variants:
                if label in optional and not optional[label](plan(*conv1), h * w):
                    continue
                chosen = forced(*conv1)
                fr.conv_plan = forced
                try:
                    before = chip_smoke.counters_now()
                    got = outs[label] = fr.resnet_block(x, emb, params, groups)
                    fused = chip_smoke.counted("k3.fused_norms", before)
                    _, rel = chip_smoke.rel_err(got, want)
                    if not rel <= chip_smoke.TOL["bfloat16"]["K3"]:
                        raise RuntimeError(f"{label} B={batch} {shape}: rel err {rel:.3e}")
                    if not torch.equal(got, fr.resnet_block(x, emb, params, groups)):
                        raise RuntimeError(f"{label} B={batch} {shape}: two launches differ")
                    ms = chip_smoke.device_ms(torch, lambda: fr.resnet_block(x, emb, params, groups), reps)
                finally:
                    fr.conv_plan = plan
                ms_of[label] = ms
                times.append(f"{label} (cluster {chosen.cluster}, multicast {chosen.multicast}, {fused} fused) "
                             f"{ms:.4f} ms rel {rel:.2e}")
            if not torch.equal(outs["plan"], outs["chain"]):
                raise RuntimeError(f"B={batch} {shape}: the planned block and the chain differ")
            ms_of["F.conv2d"] = lib = chip_smoke.device_ms(torch, chip_smoke.k3_library(torch, F, x, params), reps)
            stage = stages.setdefault(f"{h}x{w}", {})
            for label in [v for v, _ in variants] + ["F.conv2d"]:  # an optional variant that does not apply
                ms = ms_of.get(label, ms_of["plan"])                  # counts the plan's time
                totals[label] = totals.get(label, 0.0) + k3_calls.count(shape) * ms
                stage[label] = stage.get(label, 0.0) + k3_calls.count(shape) * ms
            del x, emb, params, want, got, outs
            print(f"bfloat16 B={batch:<4} {h:>2}x{w:<2} {cin:>4}->{co:<4} res={int(shape[4])} emb={int(shape[5])} "
                  f"G={groups}{'' if shape in k3_calls else ' (outside the sums)'}: " + "; ".join(times)
                  + f"; plan == chain bitwise; F.conv2d {lib:.4f} ms", flush=True)
        print(f"bfloat16 B={batch:<4} by stage (22 blocks): " + "; ".join(
            f"{st} " + ", ".join(f"{k} {v:.4f} ms" for k, v in d.items()) for st, d in stages.items()), flush=True)
        print(f"bfloat16 B={batch:<4} the 22 blocks of one forward, fused sweep: "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in totals.items()), flush=True)
        torch.cuda.empty_cache()


BASE_FLAGS = _build.NVCC_FLAGS


def load_kernels(ring):
    """Build (or reuse) and load the kernels, the bf16 conv's ring cut to
    at most ``ring`` K-slices (None: the kernel's own depth)."""
    _build.NVCC_FLAGS = BASE_FLAGS + ((f"-DNOPE_CONV_RING={ring}",) if ring else ())
    _build._library = None
    _build.library()


def sweep(dn, route, shapes, k3_calls, batches, sms, dev, gen, ring_label):
    chosen_plan = fr.conv_plan
    for batch in batches:
        reps = 20 if batch <= 341 else 3
        totals, picked_total = {}, 0.0
        for shape in shapes:
            h, w, cin, co, groups = *shape[:4], shape[6]
            m, hw = batch * h * w, h * w
            picked = chosen_plan(m, hw, co, 9 * cin // route.slice_k, sms, route, w, groups)
            x, emb, params = chip_smoke.k3_inputs(torch, shape, batch, dev, getattr(torch, dn), gen)
            want = fr.resnet_block_plain(x.float(), None if emb is None else emb.float(),
                                         {k: v.float() for k, v in params.items()}, groups)
            times = []
            for label, one in candidates(route):
                label += ring_label
                fr.conv_plan = forced_plan(one)
                try:
                    plan = fr.conv_plan(m, hw, co, 9 * cin // route.slice_k, sms, route, w, groups)
                    got = fr.resnet_block(x, emb, params, groups)
                    _, rel = chip_smoke.rel_err(got, want)
                    if not rel <= chip_smoke.TOL[dn]["K3"]:
                        raise RuntimeError(f"{dn} {label} B={batch} {shape}: rel err {rel:.3e}")
                    if not torch.equal(got, fr.resnet_block(x, emb, params, groups)):
                        raise RuntimeError(f"{dn} {label} B={batch} {shape}: two launches differ")
                    ms = chip_smoke.device_ms(torch, lambda: fr.resnet_block(x, emb, params, groups), reps)
                finally:
                    fr.conv_plan = chosen_plan
                totals[label] = totals.get(label, 0.0) + k3_calls.count(shape) * ms
                if label == tile_label(picked, route) + ring_label:
                    picked_total += k3_calls.count(shape) * ms
                times.append(f"{label} bm={plan.bm} splits={plan.splits} staged={plan.staged} {ms:.4f} ms")
            del x, emb, params, want, got
            print(f"{dn:<8} B={batch:<4} {h:>2}x{w:<2} {cin:>4}->{co:<4} res={int(shape[4])} emb={int(shape[5])} "
                  f"G={groups}{'' if shape in k3_calls else ' (outside the sums)'} conv_plan "
                  f"{tile_label(picked, route)} bm={picked.bm} splits={picked.splits}: " + "; ".join(times), flush=True)
        print(f"{dn:<8} B={batch:<4} the 22 blocks of one forward: conv_plan{ring_label} {picked_total:.4f} ms; "
              + "; ".join(f"{k} alone {v:.4f} ms" for k, v in totals.items()), flush=True)
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), action="append")
    parser.add_argument("--batch", type=int, action="append", help="batches to sweep (default: per dtype)")
    parser.add_argument("--ring", type=int, action="append", default=[],
                        help="also sweep bf16 with its ring cut to at most N K-slices (a build each)")
    parser.add_argument("--sweep", choices=("tiles", "fused"), action="append",
                        help="the tile and epilogue sweep, the fused one (default: both)")
    parser.add_argument("--plans", action="store_true", help="print the plan table (132 SMs) and stop")
    args = parser.parse_args()
    dtypes = args.dtype or ["bfloat16", "float32"]
    sweeps = args.sweep or ["tiles", "fused"]
    if args.plans:
        task = build_task(chip_smoke.flagship_config(), torch.device("cpu"), torch.Generator().manual_seed(0))
        k3_calls, _ = chip_smoke.record_shapes(torch, fr, la, task.unet)
        plan_table(sorted(set(k3_calls), key=k3_calls.index), 132)
        return 0
    if not torch.cuda.is_available():
        print("k3_tiles: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line())
    task = build_task(chip_smoke.flagship_config(), dev, torch.Generator().manual_seed(0))
    k3_calls, _ = chip_smoke.record_shapes(torch, fr, la, copy.deepcopy(task.unet).cpu())
    del task
    shapes = sorted(set(k3_calls), key=k3_calls.index) + list(chip_smoke.K3_GROUP_SHAPES)
    sms = _build.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    plan_table(sorted(set(k3_calls), key=k3_calls.index), sms)
    load_kernels(None)
    print("clusters resident at once: " + "; ".join(
        f"{tile} rows {'staged' if staged else 'registers'}: " + ", ".join(
            f"{cl} CTAs x{fr.resident_clusters(dev, tile, staged, cl)}" for cl in (1, 2, 4, 8))
        for tile in (128, 64) for staged in (True, False)), flush=True)
    if "fused" in sweeps and "bfloat16" in dtypes:
        fused_sweep(shapes, k3_calls, args.batch or (chip_smoke.FAST_N, chip_smoke.FULL_N, chip_smoke.EVAL_ITEMS[1]),
                    dev, gen)
    for ring in [None] + args.ring if "tiles" in sweeps else []:
        load_kernels(ring)
        for dn in dtypes if ring is None else [d for d in dtypes if d == "bfloat16"]:
            sweep(dn, fr.TENSOR_CORE_ROUTES[getattr(torch, dn)], shapes, k3_calls, args.batch or BATCHES[dn], sms,
                  dev, gen, "" if ring is None else f"/ring<={ring}")
    load_kernels(None)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
