#!/usr/bin/env python3
"""K3's tensor-core routes (bf16, and float32 in 3xTF32) at each tile
height their conv kernel takes.

    python3 scripts/k3_tiles.py [--dtype bfloat16|float32]

On one CUDA GPU, from the root of a checkout.  For every ResnetBlock
shape of the flagship U-Net (recorded as ``chip_smoke.py`` records them)
at B = 3, 26 and 341, the block runs with each tile height the route's
kernel takes (``fused_resnet.TENSOR_CORE_ROUTES[dtype].tiles``; 64-row
tiles split K as ``conv_plan`` does), beside the height ``conv_plan``
picks.  Each run is checked against the plain version (``chip_smoke.
TOL``: 1e-2 bf16, 1e-4 float32) and timed on the device alone: the
stream is held by a sleep while the host queues the launches, so host
time does not enter.  Both dtypes by default.
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

REPS = 20


def forced_plan(bm: int):
    """``conv_plan`` with the tile height fixed at ``bm``."""

    def plan(m, hw, c_out, k_slices, sms, route):
        tiles = -(-m // bm) * -(-c_out // fr.TILE_N)
        splits = max(1, min(route.blocks_64 * sms // tiles, k_slices // 4)) if bm == 64 else 1
        return fr.ConvPlan(bm, splits, min(bm, (bm - 2) // hw + 2))

    return plan


def device_ms(fn) -> float:
    return chip_smoke.device_ms(torch, fn, REPS)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), action="append")
    dtypes = [getattr(torch, d) for d in parser.parse_args().dtype or ("bfloat16", "float32")]
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
    shapes = sorted(set(k3_calls), key=k3_calls.index)
    sms = _build.sm_count(dev)
    gen = torch.Generator().manual_seed(1)
    chosen_plan = fr.conv_plan
    for dtype in dtypes:
        route, dn = fr.TENSOR_CORE_ROUTES[dtype], str(dtype).split(".")[-1]
        for batch in chip_smoke.K3_BATCHES:
            for shape in shapes:
                h, w, cin, co = shape[:4]
                m, hw = batch * h * w, h * w
                picked = chosen_plan(m, hw, co, 9 * cin // route.slice_k, sms, route)
                x, emb, params = chip_smoke.k3_inputs(torch, shape, batch, dev, dtype, gen)
                f32 = {k: v.float() for k, v in params.items()}
                want = fr.resnet_block_plain(x.float(), None if emb is None else emb.float(), f32, shape[6])
                times = []
                for bm in route.tiles:
                    fr.conv_plan = forced_plan(bm)
                    try:
                        got = fr.resnet_block(x, emb, params, shape[6])
                        _, rel = chip_smoke.rel_err(got, want)
                        if not rel <= chip_smoke.TOL[dn]["K3"]:
                            raise RuntimeError(f"{dn} bm={bm} B={batch} {shape}: rel err {rel:.3e}")
                        plan = fr.conv_plan(m, hw, co, 9 * cin // route.slice_k, sms, route)
                        ms = device_ms(lambda: fr.resnet_block(x, emb, params, shape[6]))
                    finally:
                        fr.conv_plan = chosen_plan
                    times.append(f"bm={bm} splits={plan.splits} {ms:.4f} ms")
                print(f"{dn:<8} B={batch:<3} {h:>2}x{w:<2} {cin:>4}->{co:<4} res={int(shape[4])} emb={int(shape[5])} "
                      f"conv_plan bm={picked.bm}: " + "; ".join(times), flush=True)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
