#!/usr/bin/env python3
"""K3's tensor-core routes (bf16, and float32 in 3xTF32) at each tile
height their conv kernels take, and in bf16 each epilogue and ring depth.

    python3 scripts/k3_tiles.py [--dtype bfloat16|float32] [--batch B ...] [--ring N ...]

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
    args = parser.parse_args()
    dtypes = args.dtype or ["bfloat16", "float32"]
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
    for ring in [None] + args.ring:
        load_kernels(ring)
        for dn in dtypes if ring is None else [d for d in dtypes if d == "bfloat16"]:
            sweep(dn, fr.TENSOR_CORE_ROUTES[getattr(torch, dn)], shapes, k3_calls, args.batch or BATCHES[dn], sms,
                  dev, gen, "" if ring is None else f"/ring<={ring}")
    load_kernels(None)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
