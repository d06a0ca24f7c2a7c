#!/usr/bin/env python3
"""Drive the PyTorch port (``nope_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA GPU, ``nvcc`` and
PyTorch built for CUDA.  It imports nothing of JAX and exits non-zero on
any failure; without a CUDA device, or without the package beside it,
it fails at once.

1. Prints the card (``nvidia-smi``), torch and CUDA versions; builds
   the kernels from ``nope_tpu_torch/csrc`` (into ``build/``).
2. Holds each kernel against its plain PyTorch version on the card, at
   every shape the flagship configuration sends through it, in float32
   and bfloat16; K3 in bfloat16 (its tensor-core route) at B = 3 (a
   ragged M), 26 and 341 (the registration batch); K2 at 3, 26 and 341
   items times each of the U-Net's token counts; K1 at the serving
   requests, B=64, a bank per query and a ragged B.  Two launches on the
   same inputs must be bitwise equal (K3 bf16, K1 and K2 both dtypes).
3. The main path, at the flagship's full width (192-wide PoseUNet with
   dim_mults (1,2,4,8), the default SD-VAE, 256-px images, 32x32x4
   latents) with seeded random weights: PoseEstimators on the 26-template
   fast grid and the 341-template level-2 "upper" grid, in bfloat16 and
   float32, each registers one object and answers three requests of 8
   queries.  Every kernel's launch count must grow.  The float32 26-grid
   answer to one query must match the CPU (plain versions) on top-1.
4. Times registration, ``estimate`` and each kernel against its plain
   version with CUDA events after warm-up, back-to-back calls with the
   host in the loop (``ms``), and each kernel also on the device alone,
   the stream held while the host queues (``device_ms``); K2 per token
   count at 26 and 341 items and summed over the 8 calls of one U-Net
   forward; K1 at B = 8, 64 against N = 26, 341; K3 per block shape beside
   ``F.conv2d`` over the block's convs (bf16, channels-last), with
   TFLOP/s.  Each kernel's bound (``bound_ms``) is the larger of the bytes
   its function must move over 3.35 TB/s and its operations over the
   peak rate of their type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
   float32 CUDA cores, from the H100 SXM data sheet; tensor-core and
   CUDA-core work overlap, so the larger of their times); a conv counts
   only its products by inputs inside the image, not by the padding.
5. One ``torch.profiler`` window each over a bf16 registration (N=26,
   N=341) and a bf16 ``estimate`` (B=64): wall time, summed kernel time,
   its share of the wall time, K3's, K2's and K1's kernel time and share,
   and the top kernels.

The last two lines are the kernel table (``ms`` with the host in the
loop, ``device_ms`` on the device alone) and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace as NS

import numpy as np

ROOT = Path(__file__).resolve().parent

# tolerances on max|kernel - plain| / max|plain|: float32 sums taken in
# another order; bfloat16 kernels compute in float32 and round the
# output once, so they are held against the plain version run in float32
# on the same bfloat16-valued inputs, within the output's rounding
TOL = {"float32": {"K1": 1e-5, "K2": 1e-5, "K3": 1e-4}, "bfloat16": {"K1": 1e-5, "K2": 1e-2, "K3": 1e-2}}
# the float32 GPU path against the CPU path on one query, same weights
CPU_SIM_RTOL = 1e-3
FAST_N, FULL_N, QUERIES, REQUESTS = 26, 341, 8, 3
K3_BATCHES = (3, FAST_N, FULL_N)
# K2 items: a ragged batch, the N=26 and the N=341 registration batches
K2_ITEMS = (3, FAST_N, FULL_N)
# K1 (B, N, bank lead): a B=64 request, the serving requests (one object's
# bank), a bank per query, a ragged B
K1_SHAPES = ((64, FULL_N, 1), (QUERIES, FAST_N, 1), (QUERIES, FULL_N, 1), (QUERIES, FAST_N, QUERIES), (3, FULL_N, 1))
K1_TIMED = ((QUERIES, FAST_N), (QUERIES, FULL_N), (64, FAST_N), (64, FULL_N))
# H100 SXM peaks (NVIDIA data sheet): bytes/s, dense bf16 tensor-core and
# float32 CUDA-core operations/s
HBM_BPS, BF16_TC_OPS, F32_OPS = 3.35e12, 989e12, 67e12
IMAGE = 256
LATENT = IMAGE // 8


def flagship_config():
    """The flagship configuration, with ``ModelConfig``'s fields."""
    return NS(
        u_net=NS(variant="vae_base", u_net_dim=192, dim_mults=(1, 2, 4, 8), rot_representation_dim=6,
                 pose_mlp_name="single_layer", resnet_block_groups=8, double_bottleneck=True),
        encoder=NS(kind="vae", latent_dim=4, block_out_channels=(128, 256, 512, 512),
                   layers_per_block=2, norm_groups=32),
        testing_config=NS(similarity_metric="l2", retrieval_k=5, half_precision_eval=True),
    )


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device time of ``fn`` alone: the stream is held by a sleep while the
    host queues ``reps`` calls, so host time does not enter."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def record_shapes(torch, fr, la, unet_cpu):
    """Record the (NHWC) inputs K3 and K2 get in one forward of the
    full-width U-Net, by running it on the CPU through the plain versions."""
    k3, k2 = [], []
    plain3, plain2 = fr.resnet_block_plain, la.linear_attention_inner_plain

    def rec3(x, emb, params, groups=8, eps=1e-5):
        k3.append((x.shape[1], x.shape[2], x.shape[3], params["w1"].shape[0],
                   "res_w" in params, emb is not None, groups))
        return plain3(x, emb, params, groups, eps)

    def rec2(qkv, heads, dim_head):
        k2.append((qkv.shape[1], heads, dim_head))
        return plain2(qkv, heads, dim_head)

    fr.resnet_block_plain, la.linear_attention_inner_plain = rec3, rec2
    try:
        with torch.no_grad():
            unet_cpu(torch.zeros(1, 4, LATENT, LATENT), torch.zeros(1, 6))
    finally:
        fr.resnet_block_plain, la.linear_attention_inner_plain = plain3, plain2
    return k3, k2


def k3_inputs(torch, shape, batch, dev, dtype, gen):
    h, w, cin, co, res, emb = shape[:6]

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev, dtype)

    params = {
        "w1": rnd(co, cin, 3, 3, scale=(9 * cin) ** -0.5), "b1": rnd(co, scale=0.1),
        "g1": (0.5 + torch.rand(co, generator=gen)).to(dev, dtype), "be1": rnd(co, scale=0.1),
        "w2": rnd(co, co, 3, 3, scale=(9 * co) ** -0.5), "b2": rnd(co, scale=0.1),
        "g2": (0.5 + torch.rand(co, generator=gen)).to(dev, dtype), "be2": rnd(co, scale=0.1),
    }
    if res:
        params["res_w"], params["res_b"] = rnd(co, cin, 1, 1, scale=cin ** -0.5), rnd(co, scale=0.1)
    return rnd(batch, h, w, cin), (rnd(batch, co) if emb else None), params


def k3_work(shape, batch):
    """(tensor-core operations, float32 operations, bytes) of one K3 block
    in bf16: its three convs, counting only the products by an input
    inside the image (a zero-padded 3x3 conv over H x W has (3H-2)(3W-2)
    such (pixel, tap) pairs of its 9HW); the two GroupNorm+SiLU passes
    (~12 operations an element with their statistics) and the residual
    add; x, weights, emb and parameters read once and the output written
    once."""
    h, w, cin, co, res, emb = shape[:6]
    m = batch * h * w
    taps = batch * (3 * h - 2) * (3 * w - 2)
    macs = taps * (cin + co) * co + (m * cin * co if res else 0)
    k = 9 * cin + 9 * co + (cin if res else 0)
    nbytes = 2 * (m * cin + m * co + k * co + (batch * co if emb else 0) + 8 * co)
    return 2.0 * macs, 25.0 * m * co, float(nbytes)


def bound(tc_ops=0.0, f32_ops=0.0, nbytes=0.0):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the largest of the tensor cores', the CUDA cores' and the memory's
    times, which can all run at once."""
    ops_ms = 1e3 * max(tc_ops / BF16_TC_OPS, f32_ops / F32_OPS)
    bytes_ms = 1e3 * nbytes / HBM_BPS
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def pack_bytes(fr, module) -> int:
    """Bytes of the K3 weight packs held for ``module``'s parameters (a
    pack that is a view of its weight holds none of its own)."""
    total = 0
    for w in module.parameters():
        entry = fr._PACKS.get(w)
        for p in entry[1].values() if entry else ():
            if p.untyped_storage().data_ptr() != w.untyped_storage().data_ptr():
                total += p.numel() * p.element_size()
    return total


def k3_library(torch, F, x, params):
    """F.conv2d over the block's convs, bf16 channels-last: the yardstick
    of the convs (no single PyTorch call computes the whole block)."""
    xc = x.permute(0, 3, 1, 2)
    act = torch.empty(x.shape[0], params["w1"].shape[0], *x.shape[1:3], dtype=x.dtype,
                      device=x.device).contiguous(memory_format=torch.channels_last)

    def run():
        F.conv2d(xc, params["w1"], params["b1"], padding=1)
        F.conv2d(act, params["w2"], params["b2"], padding=1)
        if "res_w" in params:
            F.conv2d(xc, params["res_w"], params["res_b"])
    return run


K3_KERNELS = ("conv_wgmma", "splitk_reduce", "gn_finalize", "gn_silu")  # K3 in bf16
K2_KERNELS = ("la_chunk_kernel", "la_merge_kernel", "la_output_kernel")
K1_KERNELS = ("similarity_kernel", "reduce_splits_kernel")


def profile_window(torch, label, fn, top=6):
    """Kernel time by name over one call of ``fn`` (after a warm-up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = []  # kernels only: an operator's row repeats its kernels' time
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print(f"  profile {label}: wall {wall:.2f} ms; device time not measured (the profiler saw no kernels)")
        return
    own = {k: sum(r[0] for r in rows if any(name in r[2] for name in names))
           for k, names in (("K3", K3_KERNELS), ("K2", K2_KERNELS), ("K1", K1_KERNELS))}
    print(f"  profile {label}: wall {wall:.2f} ms, kernels {busy:.2f} ms ({100 * busy / wall:.1f}% of wall), "
          + ", ".join(f"{k} {ms:.3f} ms ({100 * ms / busy:.1f}%)" for k, ms in own.items()) + " of kernel time")
    for ms, count, name in sorted(rows, reverse=True)[:top]:
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:<4} {name[:90]}")


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU only", file=sys.stderr)
        return 2
    if not (ROOT / "nope_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: nope_tpu_torch is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.ops import _build
    from nope_tpu_torch.ops import fused_resnet as fr
    from nope_tpu_torch.ops import linear_attention as la
    from nope_tpu_torch.ops import similarity as sim
    from nope_tpu_torch.serving import PoseEstimator
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} (all checks and timings)")

    # -- phase 1: build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, nvcc_s = _build.build()
    _build.library()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s (nvcc {nvcc_s:.2f} s) -> {lib_path.relative_to(ROOT)}")
    log = (lib_path.parent / "build.log").read_text()
    for line in log.splitlines():
        if "Compiling entry function" in line:
            print("  ptxas:", line.split("entry function")[1].strip().split("'")[1][:110])
        elif "registers" in line or "spill" in line:
            print("  ptxas:   ", line.replace("ptxas info    :", "").strip())

    # -- the full-width task; shapes of K3/K2 from a CPU forward --------------
    cfg = flagship_config()
    t0 = time.perf_counter()
    task32 = build_task(cfg, dev, torch.Generator().manual_seed(0))
    unet_cpu = copy.deepcopy(task32.unet).cpu()
    vae_cpu = copy.deepcopy(task32.vae).cpu()
    k3_calls, k2_calls = record_shapes(torch, fr, la, unet_cpu)
    k3_shapes = sorted(set(k3_calls), key=k3_calls.index)
    k2_tokens = sorted({n for n, _, _ in k2_calls}, reverse=True)
    print(f"built task + recorded shapes: {time.perf_counter() - t0:.1f} s; per U-Net forward "
          f"K3 x{len(k3_calls)} ({len(k3_shapes)} distinct), K2 x{len(k2_calls)} tokens {k2_tokens}")
    if len(k3_calls) != 22 or len(k2_calls) != 8:
        raise RuntimeError("unexpected U-Net structure")

    # -- phase 2: kernels against their plain versions on the card ------------
    gen = torch.Generator().manual_seed(1)
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0}

    def check(kernel, label, got, want, dtype_name):
        err, rel = rel_err(got, want)
        tol = TOL[dtype_name][kernel]
        ok = rel <= tol and torch.isfinite(got.float()).all().item()
        print(f"  {kernel} {label:<44} {dtype_name:<8} max_abs {err:.3e} rel {rel:.3e} tol {tol:.0e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{kernel} {label} {dtype_name} disagrees with its plain version")
        worst[kernel] = max(worst[kernel], err)

    print("phase 2: kernels vs plain on the card")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b, n, lead in K1_SHAPES:
            q = torch.randn(b, LATENT, LATENT, 4, generator=gen).to(dev, dtype)
            bank = torch.randn(lead, n, LATENT, LATENT, 4, generator=gen).to(dev, dtype)
            got = sim.reference_similarity(q, bank)
            check("K1", f"B={b} N={n} bank lead {lead}", got,
                  sim.reference_similarity_plain(q.float(), bank.float()), dn)
            if not torch.equal(got, sim.reference_similarity(q, bank)):
                raise RuntimeError(f"K1 B={b} N={n} lead {lead} {dn}: two launches on the same inputs differ")
            torch.cuda.synchronize()
        for items in K2_ITEMS:
            for n in k2_tokens:
                qkv = (2 * torch.randn(items, n, 384, generator=gen)).to(dev, dtype)
                got = la.linear_attention_inner(qkv, 4, 32)
                check("K2", f"items={items} n={n}", got, la.linear_attention_inner_plain(qkv.float(), 4, 32), dn)
                if not torch.equal(got, la.linear_attention_inner(qkv, 4, 32)):
                    raise RuntimeError(f"K2 items={items} n={n} {dn}: two launches on the same inputs differ")
                torch.cuda.synchronize()
        for batch in (K3_BATCHES if dtype == torch.bfloat16 else (FAST_N,)):
            for shape in k3_shapes:
                x, emb, params = k3_inputs(torch, shape, batch, dev, dtype, gen)
                f32 = {k: v.float() for k, v in params.items()}
                label = (f"B={batch} {shape[0]}x{shape[1]} {shape[2]}->{shape[3]} res={int(shape[4])} "
                         f"emb={int(shape[5])}")
                got = fr.resnet_block(x, emb, params, shape[6])
                check("K3", label, got,
                      fr.resnet_block_plain(x.float(), None if emb is None else emb.float(), f32, shape[6]), dn)
                if dtype == torch.bfloat16 and not torch.equal(got, fr.resnet_block(x, emb, params, shape[6])):
                    raise RuntimeError(f"K3 {label}: two launches on the same inputs differ")
                torch.cuda.synchronize()
    print(f"  K3 bf16: two launches bitwise equal at all {len(k3_shapes) * len(K3_BATCHES)} (shape, batch)")
    print(f"  K1 and K2, both dtypes: two launches bitwise equal at all {len(K1_SHAPES)} and "
          f"{len(K2_ITEMS) * len(k2_tokens)} shapes")

    # -- phase 3: the main path -----------------------------------------------
    print("phase 3: main path (full width, seeded random weights)")
    rng = np.random.default_rng(0)
    ref_image = rng.uniform(-1, 1, (IMAGE, IMAGE, 3)).astype(np.float32)
    requests = [rng.integers(0, 256, (QUERIES, IMAGE, IMAGE, 3), dtype=np.uint8) for _ in range(REQUESTS)]

    def variant(half):
        return PoseConditionalTask(task32.unet, task32.vae,
                                   dataclasses.replace(task32.config, half_precision_eval=half))

    estimators = {
        (dt, n): PoseEstimator(variant(dt == "bfloat16"), fast_evaluation=(n == FAST_N))
        for dt in ("bfloat16", "float32") for n in (FAST_N, FULL_N)
    }
    counters = (sim.reference_similarity, la.linear_attention_inner, fr.resnet_block)
    for fn in counters:
        fn.launches = 0
    fr.resnet_block.tensor_core_launches = 0
    answers = {}
    t0 = time.perf_counter()
    for (dt, n), est in estimators.items():
        est.register_object("object", ref_image)
        answers[(dt, n)] = [est.estimate("object", q) for q in requests]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    tc = fr.resnet_block.tensor_core_launches
    print(f"  4 registrations + {4 * REQUESTS} requests: {time.perf_counter() - t0:.1f} s; launches {launches}; "
          f"K3 on the tensor cores (bf16) {tc}")
    if not all(launches.values()) or not tc:
        raise RuntimeError(f"a kernel of the main path never launched: {launches}, tensor-core K3 {tc}")
    for (dt, n), results in answers.items():
        for r in results:
            ok = (r.nearest_idx.shape == (QUERIES, 5) and r.similarity.shape == (QUERIES, n)
                  and r.relative_rotations.shape == (QUERIES, 5, 3, 3)
                  and (r.nearest_idx >= 0).all() and (r.nearest_idx < n).all()
                  and np.isfinite(r.similarity).all())
            if not ok:
                raise RuntimeError(f"bad estimate for {dt} N={n}")
        r = results[0]
        print(f"  {dt:<8} N={n:<3} top-1 of query 0: {r.nearest_idx[0, 0]:>3} sim {r.similarity[0].max():.4f} "
              f"bank {tuple(estimators[(dt, n)]._banks['object'].shape)}")
    conv_w = sum(m.weight.numel() for m in task32.unet.modules()
                 if isinstance(m, torch.nn.Conv2d) and fr._PACKS.get(m.weight) is not None)
    print(f"  K3 weight packs held per U-Net: bf16 {pack_bytes(fr, estimators[('bfloat16', FAST_N)].task.unet) / 1e9:.3f} GB, "
          f"fp32 {pack_bytes(fr, task32.unet) / 1e9:.3f} GB ({conv_w} packed conv weights)")
    bf, fp = answers[("bfloat16", FAST_N)][0], answers[("float32", FAST_N)][0]
    print(f"  bf16 vs fp32 top-1 agreement (N={FAST_N}, {QUERIES} queries): "
          f"{(bf.nearest_idx[:, 0] == fp.nearest_idx[:, 0]).mean():.3f}")

    t0 = time.perf_counter()
    cpu_est = PoseEstimator(
        PoseConditionalTask(unet_cpu, vae_cpu, dataclasses.replace(task32.config, half_precision_eval=False)),
        fast_evaluation=True)
    cpu_est.register_object("object", ref_image)
    cpu = cpu_est.estimate("object", requests[0][:1])
    gpu = estimators[("float32", FAST_N)].estimate("object", requests[0][:1])
    err, rel = rel_err(torch.from_numpy(gpu.similarity), torch.from_numpy(cpu.similarity))
    gap = float(np.diff(np.sort(cpu.similarity[0])[-2:])[0])
    print(f"  fp32 GPU vs CPU plain path, 1 query, N={FAST_N}: top-1 {gpu.nearest_idx[0, 0]} vs "
          f"{cpu.nearest_idx[0, 0]}, sim max_abs {err:.3e} rel {rel:.3e} (tol {CPU_SIM_RTOL:.0e}), "
          f"CPU top-1 margin {gap:.4f}; {time.perf_counter() - t0:.1f} s")
    if gpu.nearest_idx[0, 0] != cpu.nearest_idx[0, 0] or rel > CPU_SIM_RTOL:
        raise RuntimeError("the float32 GPU path disagrees with the CPU path")

    # -- phase 4: timings ------------------------------------------------------
    print(f"phase 4: timings on {smi} (CUDA events after warm-up; tf32 off)")
    for (dt, n), est in estimators.items():
        reps = 3 if n == FAST_N else 2
        ms = cuda_ms(torch, lambda: est.register_object("timed", ref_image), reps)
        print(f"  register_object {dt:<8} N={n:<3} {ms:10.2f} ms")
    for dt in ("bfloat16", "float32"):
        est = estimators[(dt, FAST_N)]
        for b in (8, 64):
            q = rng.integers(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8)
            ms = cuda_ms(torch, lambda: est.estimate("object", q), 5, warmup=2)
            print(f"  estimate {dt:<8} N={FAST_N} B={b:<2} {ms:10.2f} ms  {1000 * b / ms:9.1f} queries/s")
    kernel_ms, bounds = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for b, n in K1_TIMED:
            q = torch.randn(b, LATENT, LATENT, 4, generator=gen).to(dev, dtype)
            bank = torch.randn(1, n, LATENT, LATENT, 4, generator=gen).to(dev, dtype)
            t_k = cuda_ms(torch, lambda: sim.reference_similarity(q, bank), 20, warmup=3)
            t_d = device_ms(torch, lambda: sim.reference_similarity(q, bank))
            t_p = cuda_ms(torch, lambda: sim.reference_similarity_plain(q, bank), 20, warmup=3)
            # per (query, template, pixel): 3 operations a channel, then square, sqrt, accumulate
            b1 = bound(f32_ops=float(b * n * LATENT * LATENT) * (3 * 4 + 3),
                       nbytes=float(q.numel() + bank.numel()) * q.element_size() + 4 * b * n)
            print(f"  K1 B={b:<2} N={n:<3} bank lead 1 {dn:<8} kernel {t_k:8.4f} ms (device alone {t_d:.4f}) "
                  f"plain {t_p:8.3f} ms bound {b1[0]:.4f} ms ({b1[1]}) share {100 * b1[0] / t_k:.1f}% "
                  f"(device alone {100 * b1[0] / t_d:.1f}%)")
            if (b, n) == (64, FULL_N):
                kernel_ms.setdefault("K1", (t_k, t_p, None, t_d))
                bounds.setdefault("K1", b1)
        for items in (FAST_N, FULL_N):
            fwd_k = fwd_d = fwd_p = fwd_b = 0.0
            for n in k2_tokens:
                count = sum(1 for c in k2_calls if c[0] == n)
                qkv = (2 * torch.randn(items, n, 384, generator=gen)).to(dev, dtype)
                t_k = cuda_ms(torch, lambda: la.linear_attention_inner(qkv, 4, 32), 20, warmup=3)
                t_d = device_ms(torch, lambda: la.linear_attention_inner(qkv, 4, 32))
                t_p = cuda_ms(torch, lambda: la.linear_attention_inner_plain(qkv, 4, 32), 10, warmup=2)
                # per (item, token, head): k^T v and q·context (2·2·dh² ops) and two softmaxes (~8·dh)
                b2 = bound(f32_ops=float(items * n * 4) * (4 * 32 * 32 + 8 * 32),
                           nbytes=float(qkv.numel() + items * n * 128) * qkv.element_size())
                fwd_k, fwd_d = fwd_k + count * t_k, fwd_d + count * t_d
                fwd_p, fwd_b = fwd_p + count * t_p, fwd_b + count * b2[0]
                print(f"  K2 items={items:<3} n={n:<4} x{count} {dn:<8} kernel {t_k:8.4f} ms (device alone "
                      f"{t_d:.4f}) plain {t_p:8.3f} ms bound {b2[0]:.4f} ms ({b2[1]}) share "
                      f"{100 * b2[0] / t_k:.1f}% (device alone {100 * b2[0] / t_d:.1f}%)")
                if (items, n) == (FAST_N, k2_tokens[0]):
                    kernel_ms.setdefault("K2", (t_k, t_p, None, t_d))
                    bounds.setdefault("K2", b2)
            print(f"  K2 the {len(k2_calls)} launches of one U-Net forward at items={items} {dn:<8} kernel "
                  f"{fwd_k:.4f} ms (device alone {fwd_d:.4f}) plain {fwd_p:.4f} ms bound {fwd_b:.4f} ms share "
                  f"{100 * fwd_b / fwd_k:.1f}% (device alone {100 * fwd_b / fwd_d:.1f}%)")
        for batch in ((FAST_N, FULL_N) if dtype == torch.bfloat16 else (FAST_N,)):
            tot_k = tot_d = tot_p = tot_l = tot_h = 0.0
            work = [0.0, 0.0, 0.0]
            for shape in k3_shapes:
                x, emb, params = k3_inputs(torch, shape, batch, dev, dtype, gen)
                count = k3_calls.count(shape)
                reps = 5 if batch == FAST_N else 2
                t_k = cuda_ms(torch, lambda: fr.resnet_block(x, emb, params, shape[6]), reps, warmup=2)
                t_d = device_ms(torch, lambda: fr.resnet_block(x, emb, params, shape[6]), reps)
                t_p = cuda_ms(torch, lambda: fr.resnet_block_plain(x, emb, params, shape[6]), reps, warmup=2)
                t_l = cuda_ms(torch, k3_library(torch, F, x, params), reps, warmup=2)
                torch.cuda.synchronize()
                h0 = time.perf_counter()  # the host's side alone: launches queue up
                for _ in range(reps):
                    fr.resnet_block(x, emb, params, shape[6])
                t_h = 1e3 * (time.perf_counter() - h0) / reps
                torch.cuda.synchronize()
                tc_ops, f32_ops, nbytes = k3_work(shape, batch)
                work = [a + count * b for a, b in zip(work, (tc_ops, f32_ops, nbytes))]
                tot_k, tot_p, tot_l = tot_k + count * t_k, tot_p + count * t_p, tot_l + count * t_l
                tot_d, tot_h = tot_d + count * t_d, tot_h + count * t_h
                print(f"  K3 B={batch} {shape[0]:>2}x{shape[1]:<2} {shape[2]:>4}->{shape[3]:<4} res={int(shape[4])} "
                      f"emb={int(shape[5])} x{count} {dn:<8} kernel {t_k:8.3f} ms ({tc_ops / t_k / 1e9:6.1f} TFLOP/s; "
                      f"device alone {t_d:8.3f} ms) "
                      f"plain {t_p:8.3f} ms conv2d {t_l:8.3f} ms ({tc_ops / t_l / 1e9:6.1f} TFLOP/s) "
                      f"host {t_h:6.3f} ms")
            b3 = bound(*work) if dtype == torch.bfloat16 else bound(f32_ops=work[0] + work[1], nbytes=2 * work[2])
            print(f"  K3 all 22 blocks of one U-Net forward at B={batch} {dn:<8} kernel {tot_k:8.3f} ms "
                  f"(device alone {tot_d:.3f} ms) plain {tot_p:8.3f} ms conv2d {tot_l:8.3f} ms host {tot_h:.3f} ms; "
                  f"{work[0] / 1e12:.3f} TFLOP of conv, bound {b3[0]:.3f} ms ({b3[1]}), kernel at {100 * b3[0] / tot_k:.1f}% of it")
            if batch == FAST_N:
                kernel_ms.setdefault("K3", (tot_k, tot_p, tot_l, tot_d))
                bounds.setdefault("K3", b3)
    if kernel_ms["K3"][0] >= kernel_ms["K3"][1]:
        print(f"  note: K3 bf16 per forward {kernel_ms['K3'][0]:.3f} ms is not below its plain version "
              f"{kernel_ms['K3'][1]:.3f} ms")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # -- phase 5: where the time goes ------------------------------------------
    print(f"phase 5: profiler windows on {smi}")
    for n in (FAST_N, FULL_N):
        profile_window(torch, f"register_object bfloat16 N={n}",
                       lambda: estimators[("bfloat16", n)].register_object("timed", ref_image))
    q64 = rng.integers(0, 256, (64, IMAGE, IMAGE, 3), dtype=np.uint8)
    profile_window(torch, f"estimate bfloat16 N={FAST_N} B=64",
                   lambda: estimators[("bfloat16", FAST_N)].estimate("object", q64))

    table = [
        ("reference_similarity", "K1", "nope_tpu_torch/csrc/similarity.cu",
         "nope_tpu/ops/experimental/pallas_similarity.py:29", sim.reference_similarity),
        ("linear_attention_inner", "K2", "nope_tpu_torch/csrc/linear_attention.cu",
         "nope_tpu/ops/experimental/linear_attention.py:37", la.linear_attention_inner),
        ("resnet_block", "K3", "nope_tpu_torch/csrc/fused_resnet.cu",
         "nope_tpu/ops/experimental/fused_resnet.py:156", fr.resnet_block),
    ]
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[fn.__name__], "max_abs_err": worst[k],
         "ms": kernel_ms[k][0], "plain_ms": kernel_ms[k][1], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": kernel_ms[k][2], "device_ms": kernel_ms[k][3]}
        for name, k, src, rep, fn in table
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
