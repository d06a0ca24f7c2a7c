#!/usr/bin/env python3
"""K3's float32 route (3xTF32) alone: precision first, then two timings;
then the float32 SD-VAE encode on the same conv.

    python3 scripts/k3_tf32x3.py [--only-vae]

On one CUDA GPU, from the root of a checkout (~30 s of command time, and
~1 min for the VAE phase).
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

- the float32 SD-VAE encode of 64 images at 256 px (the eval step's
  loss encodes them twice a step), on the device alone: the route
  (``models/vae.py``: its resnets' convs on ``conv_tf32x3`` in 128-column
  N tiles, GroupNorm + SiLU before them on the channels-last pair
  ``group_norm_film_silu_nhwc``) against cuDNN's conv with TF32 off
  (the route refused), each as ms an image, both against a float64
  encode of 4 of the images (rel 1e-5), the route bitwise repeatable,
  the counters ``vae.tf32x3_convs`` and ``vae.cudnn_convs`` of one encode
  (22 and 6); then each routed conv shape alone, its share of the 3xTF32
  bound (495 / 3 TFLOP/s) at the plan's tile height and the other, against
  ``F.conv2d``.  ``scripts/gn_nhwc.py`` times the GroupNorm pair, the
  VAE's norms included.

It exits non-zero if any check fails.  ``chip_smoke.py`` phases 2 and 12
hold the route at all its shapes; this is the quick check after an edit
of the kernel.  TF32 is off for the plain versions.
"""

from __future__ import annotations

import argparse
import copy
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nope_tpu_torch.models.factory import build_task  # noqa: E402
from nope_tpu_torch.models.vae import StableDiffusionVAE  # noqa: E402
from nope_tpu_torch.ops import _build  # noqa: E402
from nope_tpu_torch.ops import fused_resnet as fr  # noqa: E402
from nope_tpu_torch.ops import linear_attention as la  # noqa: E402

# (B, side, Cin, Co, k): the conv alone, up to an up block's first conv
CONVS = ((26, 32, 192, 192, 3), (3, 4, 1536, 768, 3), (26, 8, 2304, 768, 3), (26, 16, 384, 192, 1),
         (5, 3, 64, 200, 3), (341, 4, 2304, 1536, 3))
CONV_RTOL = 1e-5
BOP_ITEMS = 4 * 341
#: the eval step's float32 encode: 64 images at 256 px; 4 of them in float64
VAE_BATCH, VAE_PX, VAE_F64 = 64, 256, 4
VAE_RTOL = 1e-5
#: the routed and cuDNN convs of one SD-VAE encode
VAE_COUNTS = {"vae.tf32x3_convs": 22, "vae.cudnn_convs": 6}
#: the 3xTF32 bound: three TF32 products per float32 product
TF32X3_OPS = 495e12 / 3


def ptxas_lines(lib) -> None:
    """ptxas's register and spill lines of the 3xTF32 conv's instances, and
    any warning that it serialised their wgmmas."""
    lines = (lib.parent / "build.log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "conv_wgmma_kernelILi" in line:
            name = line.split("conv_wgmma_kernelI")[1].split("EE")[0]  # e.g. Li128ELi128ELi3: <BM, BN, STAGES>
            print(f"  ptxas: conv_wgmma_kernel<{name.replace('Li', '').replace('E', ', ')}>",
                  *(l.strip() for l in lines[i + 2:i + 4]), flush=True)
        if "wgmma" in line and "serializ" in line:
            print("  ptxas:", line.strip(), flush=True)


def time_convs(shapes, dev, gen, label, smi) -> None:
    """Each routed conv shape alone, device time: the route at its plan's
    tile height and at the other, and F.conv2d (TF32 off) on the same
    channels-last input; shares of the 3xTF32 bound."""
    route = fr.TENSOR_CORE_ROUTES[torch.float32]
    plan_of = fr.conv_plan
    total = {"plan": 0.0, "other": 0.0, "cudnn": 0.0}
    flops_all = 0.0
    for (b, h, w, cin), (co, _, k, _), n in shapes:
        x = torch.randn(b, h, w, cin, generator=gen, device=dev)
        wt = torch.randn(co, cin, k, k, generator=gen, device=dev) * (k * k * cin) ** -0.5
        bias = 0.1 * torch.randn(co, generator=gen, device=dev)
        plan = plan_of(b * h * w, h * w, co, k * k * cin // route.slice_k, _build.sm_count(dev), route)
        other = 64 if plan.bm == 128 else 128
        ms = {"plan": cs.device_ms(torch, lambda: fr.conv_tf32x3(x, wt, bias), 3)}
        try:
            fr.conv_plan = lambda *a, **kw: plan._replace(bm=other, tile=other)
            ms["other"] = cs.device_ms(torch, lambda: fr.conv_tf32x3(x, wt, bias), 3)
        finally:
            fr.conv_plan = plan_of
        xc = x.permute(0, 3, 1, 2).contiguous()  # NCHW, as nn.GroupNorm hands it to cuDNN off the route
        ms["cudnn"] = cs.device_ms(torch, lambda: F.conv2d(xc, wt, bias, padding=k // 2), 3)
        flops = 2.0 * b * h * w * co * k * k * cin
        flops_all += n * flops
        for key in total:
            total[key] += n * ms[key]
        share = {key: 100 * flops / TF32X3_OPS / (v * 1e-3) for key, v in ms.items()}
        print(f"  {label} conv x{n} B={b} {h}x{w} {cin}->{co} {k}x{k}, N tile {fr.n_tile(route, co, False)}: "
              f"bm {plan.bm} {ms['plan']:.3f} ms ({share['plan']:.1f}% of 3xTF32), bm {other} {ms['other']:.3f} ms "
              f"({share['other']:.1f}%), F.conv2d {ms['cudnn']:.3f} ms", flush=True)
        del x, xc
    share = {key: 100 * flops_all / TF32X3_OPS / (v * 1e-3) for key, v in total.items()}
    print(f"{label} routed convs of one encode ({flops_all / 1e9 / VAE_BATCH:.1f} GFLOP an image): "
          + ", ".join(f"{key} {v / VAE_BATCH:.3f} ms an image ({share[key]:.1f}% of 3xTF32)"
                      for key, v in total.items()) + f" [{smi}]", flush=True)


def vae_phase(dev, gen, smi) -> int:
    """The float32 SD-VAE encode on the route and on cuDNN; see the module
    docstring.  Returns the number of failed checks."""
    fails = 0
    torch.manual_seed(0)
    vae = StableDiffusionVAE().to(dev).eval()
    images = torch.rand(VAE_BATCH, VAE_PX, VAE_PX, 3, generator=gen, device=dev) * 2 - 1
    shapes = {}
    conv = fr.conv_tf32x3

    def recording(x, w, bias):
        key = (tuple(x.shape), tuple(w.shape))
        shapes[key] = shapes.get(key, 0) + 1
        return conv(x, w, bias)

    def encode():
        return vae.encode_image(images)

    def cudnn_encode():
        routes = fr.tf32x3_routes
        fr.tf32x3_routes = lambda *a: False
        try:
            return vae.encode_image(images)
        finally:
            fr.tf32x3_routes = routes

    with torch.no_grad():
        before = cs.counters_now()
        fr.conv_tf32x3 = recording
        try:
            got = encode()
        finally:
            fr.conv_tf32x3 = conv
        counts = {name: cs.counted(name, before) for name in VAE_COUNTS}
        again = torch.equal(got, encode())
        want = cudnn_encode()
        vae64 = copy.deepcopy(vae).double()
        exact = vae64.encode_image(images[:VAE_F64].double())
        del vae64
        _, rel = cs.rel_err(got[:VAE_F64].double(), exact)
        _, rel_cudnn = cs.rel_err(want[:VAE_F64].double(), exact)
        _, rel_pair = cs.rel_err(got, want)
        peak = {}
        for label, fn in (("route", encode), ("cudnn", cudnn_encode)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            fn()
            torch.cuda.synchronize()
            peak[label] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        ms = {"route": cs.device_ms(torch, encode, 3), "cudnn": cs.device_ms(torch, cudnn_encode, 3)}
        bf16 = copy.deepcopy(vae).to(torch.bfloat16)
        before16 = cs.counters_now()
        bf16.encode_image(images.to(torch.bfloat16))
        counts16 = {name: cs.counted(name, before16) for name in VAE_COUNTS}
        del bf16
    ok = rel <= VAE_RTOL and again and counts == VAE_COUNTS and not any(counts16.values())
    fails += not ok
    print(f"VAE fp32 encode B={VAE_BATCH} {VAE_PX}px, device alone: route {ms['route'] / VAE_BATCH:.3f} ms an image, "
          f"cuDNN {ms['cudnn'] / VAE_BATCH:.3f} ms an image; vs float64 ({VAE_F64} images): route {rel:.3e}, cuDNN "
          f"fp32 {rel_cudnn:.3e}; route vs cuDNN {rel_pair:.3e}; bitwise {again}; counters {counts} (bf16 encode "
          f"{counts16}); peak above the inputs: route {peak['route']:.2f} GB, cuDNN {peak['cudnn']:.2f} GB "
          f"{'ok' if ok else 'FAIL'} [{smi}]", flush=True)
    # where the time of each encode goes, by kernel
    for label, fn in (("route", encode), ("cudnn", cudnn_encode)):
        with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(((e.key, e.device_time_total, e.count) for e in prof.key_averages() if e.device_time_total > 0),
                      key=lambda r: -r[1])
        total = sum(r[1] for r in rows)
        print(f"VAE fp32 encode ({label}) by kernel, {total / 1e3 / VAE_BATCH:.3f} ms of device time an image:",
              flush=True)
        for key, us, n in rows[:14]:
            print(f"  {us / 1e3 / VAE_BATCH:7.3f} ms an image ({100 * us / total:4.1f}%) x{n:3d} {key[:110]}", flush=True)
    shape_list = [(xs, ws, n) for (xs, ws), n in shapes.items()]
    time_convs(shape_list, dev, gen, "VAE", smi)
    return fails


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only-vae", action="store_true", help="run the VAE phase alone")
    args = parser.parse_args()
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
    ptxas_lines(lib)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    fails = 0
    if args.only_vae:
        fails += vae_phase(dev, gen, smi)
        print("ok" if not fails else f"{fails} checks failed")
        return 1 if fails else 0
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
    fails += vae_phase(dev, gen, smi)
    print("ok" if not fails else f"{fails} checks failed")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
