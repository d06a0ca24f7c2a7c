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
   and bfloat16.
3. The main path, at the flagship's full width (192-wide PoseUNet with
   dim_mults (1,2,4,8), the default SD-VAE, 256-px images, 32x32x4
   latents) with seeded random weights: PoseEstimators on the 26-template
   fast grid and the 341-template level-2 "upper" grid, in bfloat16 and
   float32, each registers one object and answers three requests of 8
   queries.  Every kernel's launch count must grow.  The float32 26-grid
   answer to one query must match the CPU (plain versions) on top-1.
4. Times registration, ``estimate`` and each kernel against its plain
   version with CUDA events after warm-up.

The last two lines are the kernel table and ``{"ok": true, ...}``.
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


def main() -> int:
    import torch

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
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

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
        for b, n, lead in ((64, FULL_N, 1), (8, FAST_N, 1), (8, FAST_N, 8)):
            q = torch.randn(b, LATENT, LATENT, 4, generator=gen).to(dev, dtype)
            bank = torch.randn(lead, n, LATENT, LATENT, 4, generator=gen).to(dev, dtype)
            check("K1", f"B={b} N={n} bank lead {lead}", sim.reference_similarity(q, bank),
                  sim.reference_similarity_plain(q.float(), bank.float()), dn)
            torch.cuda.synchronize()
        for n in k2_tokens:
            qkv = (2 * torch.randn(FAST_N, n, 384, generator=gen)).to(dev, dtype)
            check("K2", f"BN={FAST_N} n={n}", la.linear_attention_inner(qkv, 4, 32),
                  la.linear_attention_inner_plain(qkv.float(), 4, 32), dn)
            torch.cuda.synchronize()
        for shape in k3_shapes:
            x, emb, params = k3_inputs(torch, shape, FAST_N, dev, dtype, gen)
            f32 = {k: v.float() for k, v in params.items()}
            label = f"B={FAST_N} {shape[0]}x{shape[1]} {shape[2]}->{shape[3]} res={int(shape[4])} emb={int(shape[5])}"
            check("K3", label, fr.resnet_block(x, emb, params, shape[6]),
                  fr.resnet_block_plain(x.float(), None if emb is None else emb.float(), f32, shape[6]), dn)
            torch.cuda.synchronize()

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
    answers = {}
    t0 = time.perf_counter()
    for (dt, n), est in estimators.items():
        est.register_object("object", ref_image)
        answers[(dt, n)] = [est.estimate("object", q) for q in requests]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"  4 registrations + {4 * REQUESTS} requests: {time.perf_counter() - t0:.1f} s; launches {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the main path never launched: {launches}")
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
    kernel_ms = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        q = torch.randn(64, LATENT, LATENT, 4, generator=gen).to(dev, dtype)
        bank = torch.randn(1, FULL_N, LATENT, LATENT, 4, generator=gen).to(dev, dtype)
        t_k = cuda_ms(torch, lambda: sim.reference_similarity(q, bank), 20, warmup=3)
        t_p = cuda_ms(torch, lambda: sim.reference_similarity_plain(q, bank), 20, warmup=3)
        print(f"  K1 B=64 N={FULL_N} bank lead 1 {dn:<8} kernel {t_k:8.3f} ms plain {t_p:8.3f} ms")
        kernel_ms.setdefault("K1", (t_k, t_p))
        n = k2_tokens[0]
        qkv = (2 * torch.randn(FAST_N, n, 384, generator=gen)).to(dev, dtype)
        t_k = cuda_ms(torch, lambda: la.linear_attention_inner(qkv, 4, 32), 20, warmup=3)
        t_p = cuda_ms(torch, lambda: la.linear_attention_inner_plain(qkv, 4, 32), 20, warmup=3)
        print(f"  K2 BN={FAST_N} n={n} {dn:<8} kernel {t_k:8.3f} ms plain {t_p:8.3f} ms")
        kernel_ms.setdefault("K2", (t_k, t_p))
        tot_k = tot_p = 0.0
        for shape in k3_shapes:
            x, emb, params = k3_inputs(torch, shape, FAST_N, dev, dtype, gen)
            t_k = cuda_ms(torch, lambda: fr.resnet_block(x, emb, params, shape[6]), 3)
            t_p = cuda_ms(torch, lambda: fr.resnet_block_plain(x, emb, params, shape[6]), 3)
            count = k3_calls.count(shape)
            tot_k, tot_p = tot_k + count * t_k, tot_p + count * t_p
            print(f"  K3 B={FAST_N} {shape[0]:>2}x{shape[1]:<2} {shape[2]:>4}->{shape[3]:<4} res={int(shape[4])} "
                  f"emb={int(shape[5])} x{count} {dn:<8} kernel {t_k:8.3f} ms plain {t_p:8.3f} ms")
        print(f"  K3 all 22 blocks of one U-Net forward at B={FAST_N} {dn:<8} kernel {tot_k:8.3f} ms "
              f"plain {tot_p:8.3f} ms")
        kernel_ms.setdefault("K3", (tot_k, tot_p))
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

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
         "ms": kernel_ms[k][0], "plain_ms": kernel_ms[k][1]}
        for name, k, src, rep, fn in table
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
