#!/usr/bin/env python3
"""K3's float32 route (3xTF32) alone: precision first, then two timings.

    python3 scripts/k3_tf32x3.py

On one CUDA GPU, from the root of a checkout (~30 s of command time).
Builds the kernels, prints ``ptxas``'s register and spill lines of the
conv, then:

- the 3xTF32 conv alone (``fused_resnet.conv_tf32x3``) at six shapes up
  to the widest K of the flagship U-Net (9 x 2304), against its plain
  split arithmetic (``conv_tf32x3_plain``) and against a float64 conv,
  and twice for bitwise repeatability (rel 1e-5 each);
- every ResnetBlock shape of the flagship U-Net at B = 3, 26 and 341
  through ``resnet_block`` in float32, against ``resnet_block_plain``
  (``chip_smoke.TOL``: 1e-4), bitwise repeatable, each on the route;
- the two 32x32 block shapes at 1,364 items (the BOP CLI's bank of 4 x
  341), on the device alone: the route, ``_block_cuda_cores`` (the
  exact CUDA-core route), the plain version and ``F.conv2d``.

It exits non-zero if any check fails.  ``chip_smoke.py`` phases 2 and 12
hold the route at all its shapes; this is the quick check after an edit
of the kernel.  TF32 is off for the plain versions.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nope_tpu_torch.models.factory import build_task  # noqa: E402
from nope_tpu_torch.ops import _build  # noqa: E402
from nope_tpu_torch.ops import fused_resnet as fr  # noqa: E402
from nope_tpu_torch.ops import linear_attention as la  # noqa: E402

# (B, side, Cin, Co, k): the conv alone, up to an up block's first conv
CONVS = ((26, 32, 192, 192, 3), (3, 4, 1536, 768, 3), (26, 8, 2304, 768, 3), (26, 16, 384, 192, 1),
         (5, 3, 64, 200, 3), (341, 4, 2304, 1536, 3))
CONV_RTOL = 1e-5
BOP_ITEMS = 4 * 341


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_tf32x3: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib, _ = _build.build()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    lines = (lib.parent / "build.log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "conv_wgmma_kernelIf" in line:
            print("  ptxas:", line.split("'")[1][-60:], *(l.strip() for l in lines[i + 2:i + 4]), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    fails = 0
    for b, side, cin, co, k in CONVS:
        x = torch.randn(b, side, side, cin, generator=gen, device=dev)
        w = torch.randn(co, cin, k, k, generator=gen, device=dev) * (k * k * cin) ** -0.5
        bias = 0.1 * torch.randn(co, generator=gen, device=dev)
        got = fr.conv_tf32x3(x, w, bias)
        _, split = cs.rel_err(got, fr.conv_tf32x3_plain(x, w, bias))
        exact = F.conv2d(x.double().permute(0, 3, 1, 2), w.double(), bias.double(), padding=k // 2)
        _, f64 = cs.rel_err(got, exact.permute(0, 2, 3, 1))
        again = torch.equal(got, fr.conv_tf32x3(x, w, bias))
        ok = split <= CONV_RTOL and f64 <= CONV_RTOL and again
        fails += not ok
        print(f"conv B={b} {side}x{side} {cin}->{co} {k}x{k}: vs split plain {split:.3e}, vs float64 {f64:.3e}, "
              f"bitwise {again} {'ok' if ok else 'FAIL'}", flush=True)
    task = build_task(cs.flagship_config(), torch.device("cpu"), torch.Generator().manual_seed(0))
    k3_calls, _ = cs.record_shapes(torch, fr, la, task.unet)
    shapes = sorted(set(k3_calls), key=k3_calls.index)
    del task
    tol = cs.TOL["float32"]["K3"]
    for batch in cs.K3_BATCHES:
        for shape in shapes:
            x, emb, params = cs.k3_inputs(torch, shape, batch, dev, torch.float32, gen)
            before = cs.counters_now()
            got = fr.resnet_block(x, emb, params, shape[6])
            ran = cs.counted("k3.tf32x3_launches", before)
            _, rel = cs.rel_err(got, fr.resnet_block_plain(x, emb, params, shape[6]))
            again = torch.equal(got, fr.resnet_block(x, emb, params, shape[6]))
            ok = rel <= tol and again and ran == 1
            fails += not ok
            print(f"K3 fp32 B={batch} {shape[:6]}: rel {rel:.3e}, bitwise {again}, 3xTF32 {ran == 1} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
    for shape in [sh for sh in shapes if sh[0] == 32][:2]:
        x, emb, params = cs.k3_inputs(torch, shape, BOP_ITEMS, dev, torch.float32, gen)
        out = torch.empty(*x.shape[:3], shape[3], device=dev)
        times = {
            "3xTF32": cs.device_ms(torch, lambda: fr.resnet_block(x, emb, params, shape[6]), 2),
            "conv_nhwc": cs.device_ms(torch, lambda: fr._block_cuda_cores(x, emb, params, shape[6], 1e-5, out), 2),
            "plain": cs.device_ms(torch, lambda: fr.resnet_block_plain(x, emb, params, shape[6]), 2),
            "conv2d": cs.device_ms(torch, cs.k3_library(torch, F, x, params), 2),
        }
        print(f"{BOP_ITEMS} items {shape[:6]}, device alone: "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items()) + f" [{smi}]", flush=True)
        del x, emb, params, out
    print("ok" if not fails else f"{fails} checks failed")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
