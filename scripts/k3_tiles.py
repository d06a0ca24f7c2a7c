#!/usr/bin/env python3
"""K3's bf16 tensor-core route at each tile height its conv kernel takes.

    python3 scripts/k3_tiles.py

On one CUDA GPU, from the root of a checkout.  For every ResnetBlock
shape of the flagship U-Net (recorded as ``chip_smoke.py`` records them)
at B = 3, 26 and 341, the block runs with each tile height the kernel
takes (``fused_resnet.TILE_M``; 64-row tiles split K as ``conv_plan``
does), beside the height ``conv_plan`` picks.  Each run is checked
against the plain version (bf16 tolerance 1e-2) and timed on the device
alone: the stream is held by a sleep while the host queues the
launches, so host time does not enter.
"""

from __future__ import annotations

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

    def plan(m, hw, c_out, k_slices, sms):
        tiles = -(-m // bm) * -(-c_out // fr.TILE_N)
        splits = max(1, min(2 * sms // tiles, k_slices // 4)) if bm == 64 else 1
        return fr.ConvPlan(bm, splits, min(bm, (bm - 2) // hw + 2))

    return plan


def device_ms(fn) -> float:
    return chip_smoke.device_ms(torch, fn, REPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_tiles: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line())
    task = build_task(chip_smoke.flagship_config(), dev, torch.Generator().manual_seed(0))
    k3_calls, _ = chip_smoke.record_shapes(torch, fr, la, copy.deepcopy(task.unet).cpu())
    del task
    shapes = sorted(set(k3_calls), key=k3_calls.index)
    sms = _build.sm_count(dev)
    gen = torch.Generator().manual_seed(1)
    chosen_plan = fr.conv_plan
    for batch in chip_smoke.K3_BATCHES:
        for shape in shapes:
            h, w, cin, co = shape[:4]
            m, hw = batch * h * w, h * w
            picked = chosen_plan(m, hw, co, 9 * cin // fr.SLICE_K, sms)
            x, emb, params = chip_smoke.k3_inputs(torch, shape, batch, dev, torch.bfloat16, gen)
            f32 = {k: v.float() for k, v in params.items()}
            want = fr.resnet_block_plain(x.float(), None if emb is None else emb.float(), f32, shape[6])
            times = []
            for bm in fr.TILE_M:
                fr.conv_plan = forced_plan(bm)
                try:
                    got = fr.resnet_block(x, emb, params, shape[6])
                    _, rel = chip_smoke.rel_err(got, want)
                    if not rel <= 1e-2:
                        raise RuntimeError(f"bm={bm} B={batch} {shape}: rel err {rel:.3e}")
                    plan = fr.conv_plan(m, hw, co, 9 * cin // fr.SLICE_K, sms)
                    ms = device_ms(lambda: fr.resnet_block(x, emb, params, shape[6]))
                finally:
                    fr.conv_plan = chosen_plan
                times.append(f"bm={bm} splits={plan.splits} {ms:.4f} ms")
            print(f"B={batch:<3} {h:>2}x{w:<2} {cin:>4}->{co:<4} res={int(shape[4])} emb={int(shape[5])} "
                  f"conv_plan bm={picked.bm}: " + "; ".join(times), flush=True)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
