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
   ragged M), 26 and 341 (the registration batch), and its 32x32 blocks
   at the evaluation program's 1,984 and 3,328 U-Net items (64 x 31 and
   128 x 26); K2 at 3, 26 and 341 items times each of the U-Net's token
   counts, and in bfloat16 at 1,984 and 3,328; K1 at the serving
   requests, B=64, a bank per query (also the evaluation program's
   (64, 31), (128, 26) and (8, 341)) and a ragged B.  Two launches on the
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
   count at 26 and 341 items (and 1,984 and 3,328 in bf16) and summed
   over the 8 calls of one U-Net forward; K1 at B = 8, 64 against N = 26,
   341 and with a bank per query at (64, 31) and (128, 26); K3 per block
   shape (bf16 also at 1,984 and 3,328 items) beside ``F.conv2d`` over
   the block's convs (bf16, channels-last), with TFLOP/s.  After phase 6
   (4b), the evaluation program, median of 3: images/s of ``bench.py``'s
   two shapes, bank plus retrieval only (fast: B=128, N=26, bank made
   whole; full: B=64, N=341, streamed in chunks of 31) and of the whole
   eval step with its float32 loss, and ``estimate_many`` at B=64 over 4
   objects.  Each kernel's bound (``bound_ms``) is the larger of the bytes
   its function must move over 3.35 TB/s and its operations over the
   peak rate of their type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
   float32 CUDA cores, from the H100 SXM data sheet; tensor-core and
   CUDA-core work overlap, so the larger of their times); a conv counts
   only its products by inputs inside the image, not by the padding.
5. One ``torch.profiler`` window each over a bf16 registration (N=26,
   N=341), a bf16 ``estimate`` (B=64) and, after phase 6 (5b), one
   full-protocol eval step:
   wall time, summed kernel time, its share of the wall time, K3's, K2's
   and K1's kernel time and share, and the top kernels.
6. The evaluation program (``evaluation.geodesic.evaluate_geodesic``)
   at full width on synthetic batches (grid poses, seeded images,
   symmetry cycling 0/1/2): (a) the fast protocol (B=128, N=26, bf16, the
   bank made whole) and the full one (B=64, N=341, bf16, streamed in
   chunks of 31), with their ``.npz`` dumps under ``build/chip_smoke/``,
   their peak memory, every kernel's launch count grown, and proof that
   the streamed peak does not grow with N; (b) streamed against
   materialised (fp32 B=2 N=26, bf16 B=4 N=341) and planted top-k ties;
   (c) the fp32 eval step against the CPU path; (d) ``estimate_many``
   against ``estimate``, an int8 gallery against the bf16 one, and a
   saved and reloaded registry answering bitwise as before.

Phases run in the order 1 to 6, so phases 4 and 5 time the serving
path and the kernels in a process that holds only phase 3's modules
(more live modules slow the host's side of each call); then 4b times the evaluation program (images/s of both
protocols, ``estimate_many``) and 5b profiles one full-protocol eval
step.  The last two lines are the kernel table (``ms`` with the host
in the loop, ``device_ms`` on the device alone, ``launches`` of phase 3,
``eval_launches`` of phase 6 (a)) and ``{"ok": true, ...}``.
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
# bank), a bank per query, a ragged B; the evaluation program's banks per
# query: a full-protocol chunk, the fast protocol, estimate_many's gather
K1_SHAPES = ((64, FULL_N, 1), (QUERIES, FAST_N, 1), (QUERIES, FULL_N, 1), (QUERIES, FAST_N, QUERIES), (3, FULL_N, 1),
             (64, 31, 64), (128, FAST_N, 128), (QUERIES, FULL_N, QUERIES))
K1_TIMED = ((QUERIES, FAST_N, 1), (QUERIES, FULL_N, 1), (64, FAST_N, 1), (64, FULL_N, 1), (64, 31, 64),
            (128, FAST_N, 128))
# the evaluation program (bench.py's two protocols): (B, N, chunk_size);
# the fast bank is made whole, the full one streamed
EVAL = {"fast": (128, FAST_N, None), "full": (64, FULL_N, 31)}
# U-Net items of one evaluation forward: a full-protocol chunk, the fast bank
EVAL_ITEMS = (64 * 31, 128 * FAST_N)
# streamed against materialised in bfloat16: the top-1 is held where its
# margin over the second exceeds this share of the row's largest |score|
BF16_SIM_RTOL = 1e-2
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
                   layers_per_block=2, norm_groups=32, using_KL=False),
        optim_config=NS(loss_type="l1", use_inv_deltaR=True),
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


def median_ms(torch, fn, reps: int = 3, warmup: int = 1) -> float:
    """Median over ``reps`` calls of ``fn``, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def eval_batch(torch, grid, b, seed):
    """One numpy eval batch over the template grid ``grid`` (N, 3, 3),
    built as ``tests/test_task.py`` builds one: the reference at grid pose
    0, queries at seeded grid poses, seeded images, symmetry 0/1/2."""
    from nope_tpu_torch.geometry.rotations import matrix_to_rotation_6d
    from nope_tpu_torch.geometry.transforms import relative_rotation

    rng = np.random.default_rng(seed)
    n = len(grid)
    g = torch.from_numpy(np.ascontiguousarray(grid))
    query_pose = grid[rng.integers(0, n, b)]
    all_rel = relative_rotation(g[None].expand(b, n, 3, 3), g[0].expand(b, n, 3, 3))
    gt_rel = relative_rotation(torch.from_numpy(query_pose), g[0].expand(b, 3, 3))
    return {
        "query": rng.uniform(-1, 1, (b, IMAGE, IMAGE, 3)).astype(np.float32),
        "reference": rng.uniform(-1, 1, (b, IMAGE, IMAGE, 3)).astype(np.float32),
        "gt_relativeR": matrix_to_rotation_6d(gt_rel).numpy(),
        "all_relativeR": matrix_to_rotation_6d(all_rel).numpy(),
        "query_pose": query_pose,
        "template_poses": np.ascontiguousarray(np.broadcast_to(grid, (b, n, 3, 3))),
        "symmetry": np.arange(b) % 3,
    }


def on_device(torch, batch, dev, dtype=None):
    """A numpy batch as tensors on ``dev``; images and poses cast to
    ``dtype`` when given (what the eval step feeds its bf16 copy)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
    if dtype is not None:
        for k in ("query", "reference", "all_relativeR"):
            out[k] = out[k].to(dtype)
    return out


def k3_inputs(torch, shape, batch, dev, dtype, gen):
    """Seeded inputs of one K3 block, drawn on ``gen``'s device."""
    h, w, cin, co, res, emb = shape[:6]

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=gen.device) * scale).to(dev, dtype)

    params = {
        "w1": rnd(co, cin, 3, 3, scale=(9 * cin) ** -0.5), "b1": rnd(co, scale=0.1),
        "g1": (0.5 + torch.rand(co, generator=gen, device=gen.device)).to(dev, dtype), "be1": rnd(co, scale=0.1),
        "w2": rnd(co, co, 3, 3, scale=(9 * co) ** -0.5), "b2": rnd(co, scale=0.1),
        "g2": (0.5 + torch.rand(co, generator=gen, device=gen.device)).to(dev, dtype), "be2": rnd(co, scale=0.1),
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


GALLERY = ("mug", "cup", "can", "box")
MIXED = ("cup", "mug", "can", "cup", "can", "mug", "mug", "cup")


def evaluation_phase(torch, dev, task32, variant, grids, counters, unet_cpu, vae_cpu, rng):
    """Phase 6: the evaluation program and the gallery side of serving.
    Returns what phases 4 and 5 time: the launch counts of (a), the bf16
    copy of the modules, the batches, the chunk sizes, a 4-object gallery."""
    from nope_tpu_torch.evaluation.geodesic import evaluate_geodesic
    from nope_tpu_torch.ops import fused_resnet as fr
    from nope_tpu_torch.ops import similarity as sim
    from nope_tpu_torch.serving import PoseEstimator
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask

    print("phase 6: the evaluation program (full width, seeded random weights)")
    out_root = ROOT / "build" / "chip_smoke"
    batches = {name: eval_batch(torch, grids[n], b, seed) for seed, (name, (b, n, _)) in enumerate(EVAL.items(), 10)}

    # (a) both protocols through evaluate_geodesic, every kernel counted over them
    for fn in counters:
        fn.launches = 0
    fr.resnet_block.tensor_core_launches = 0
    chunks = {}
    for name, (b, n, chunk) in EVAL.items():

        def run(chunk):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            scores = evaluate_geodesic(task32, [batches[name]], chunk_size=chunk, save_dir=str(out_root / name),
                                       tag=name)
            torch.cuda.synchronize()
            return scores, time.perf_counter() - t0

        try:
            scores, wall = run(chunk)
        except torch.cuda.OutOfMemoryError:
            if chunk is not None:
                raise
            chunk = 13
            print(f"  {name}: the materialised (B={b}, N={n}) bank does not fit on the card; running the "
                  f"JAX package's chunked path instead, chunk_size={chunk} (streamed)")
            torch.cuda.empty_cache()
            scores, wall = run(chunk)
        chunks[name] = chunk
        peak = torch.cuda.max_memory_allocated() / 2**30
        with np.load(out_root / name / f"pred_{name}_batch0_rank0.npz") as d:
            dump = {k: d[k] for k in d.files}
        idx, err = dump["nearest_idx"], dump["error_deg"]
        ok = (dump["similarity"].shape == (b, n) and np.isfinite(dump["similarity"]).all()
              and idx.shape == (b, 5) and ((idx >= 0) & (idx < n)).all()
              and err.shape == (b,) and ((err >= 0) & (err <= 180)).all()
              and scores["num_images"] == b and np.isfinite(scores["loss"])
              and all(0 <= v <= (100 if "accuracy" in k else 180) for k, v in scores.items() if k.startswith("top")))
        print(f"  {name}: B={b} N={n} chunk_size {chunk} bf16: {wall:.2f} s in evaluate_geodesic (with its bf16 copy "
              f"of the modules), peak memory {peak:.2f} GiB; loss {scores['loss']:.6f}, top1 acc15 "
              f"{scores['top1, accuracy_15']:.2f}, top5 acc30 {scores['top5, accuracy_30']:.2f}, top1 median "
              f"{scores['top1, median']:.2f} deg; dump keys {sorted(dump)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"the {name} protocol's outputs are malformed: {scores}")
    launches = {fn.__name__: fn.launches for fn in counters}
    tc = fr.resnet_block.tensor_core_launches
    print(f"  launches over both protocols {launches}; K3 on the tensor cores (bf16) {tc}, on the CUDA cores "
          f"(the fp32 loss) {launches['resnet_block'] - tc}")
    if not all(launches.values()) or not tc or launches["resnet_block"] == tc:
        raise RuntimeError(f"a kernel of the evaluation program never launched: {launches}, tensor-core K3 {tc}")

    # the streamed peak does not grow with N: the (B, N, h, w, C) bank never exists
    half = task32.half()
    b, n, _ = EVAL["full"]
    chunk = chunks["full"]
    fb = on_device(torch, batches["full"], dev, torch.bfloat16)
    q_lat, r_lat = half.encode(fb["query"]), half.encode(fb["reference"])

    def stream_peak(m):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        half.stream_similarity(q_lat, r_lat, fb["all_relativeR"][:, :m], chunk)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    stream_peak(2 * chunk)  # packs K3's weights for this copy
    small, full = stream_peak(2 * chunk), stream_peak(n)
    bank = b * n * LATENT * LATENT * 4 * 2
    print(f"  streamed B={b} chunk_size {chunk}, peak above the inputs: N={2 * chunk} {small / 2**30:.4f} GiB, "
          f"N={n} {full / 2**30:.4f} GiB; the (B, N, h, w, C) bf16 bank alone would be {bank / 2**30:.4f} GiB")
    if full - small > bank / 4:
        raise RuntimeError("the streamed peak grows with N: the bank was made whole")
    del fb, q_lat, r_lat

    # (b) streamed against materialised, on the card
    t32 = variant(False)
    b2 = on_device(torch, eval_batch(torch, grids[FAST_N], 2, 20), dev)
    s_m, i_m = t32.retrieval(b2["query"], t32.generate_template_bank(b2["reference"], b2["all_relativeR"]))
    s_s, i_s = t32.retrieve_streaming(b2["query"], b2["reference"], b2["all_relativeR"], 13)
    err, rel = rel_err(s_s, s_m)
    same = torch.equal(i_s, i_m)
    print(f"  streamed vs materialised, fp32 B=2 N={FAST_N} chunk_size 13: max_abs {err:.3e} rel {rel:.3e} "
          f"(tol 1e-05), nearest_idx {'equal' if same else 'DIFFER'}")
    if rel > 1e-5 or not same:
        raise RuntimeError("the streamed fp32 retrieval disagrees with the materialised one")
    b4 = on_device(torch, eval_batch(torch, grids[FULL_N], 4, 21), dev, torch.bfloat16)
    s_m, i_m = half.retrieval(b4["query"], half.generate_template_bank(b4["reference"], b4["all_relativeR"]))
    s_s, i_s = half.retrieve_streaming(b4["query"], b4["reference"], b4["all_relativeR"], 31)
    top2 = s_m.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > BF16_SIM_RTOL * s_m.abs().amax(1)
    same = i_s[:, 0] == i_m[:, 0]
    err, rel = rel_err(s_s, s_m)
    print(f"  streamed vs materialised, bf16 B=4 N={FULL_N} chunk_size 31: max_abs {err:.3e} rel {rel:.3e} (tol "
          f"{BF16_SIM_RTOL:.0e}); top-1 margin above {BF16_SIM_RTOL:.0e} of |score| in {int(decided.sum())} of 4 "
          f"rows, top-1 equal in {int(same.sum())} of 4 rows")
    if rel > BF16_SIM_RTOL or not same[decided].all():
        raise RuntimeError("the streamed bf16 retrieval disagrees with the materialised one on a clear top-1")

    # planted ties: lower index first, as jax.lax.top_k
    g = torch.Generator().manual_seed(3)
    for n in (8, FAST_N, FULL_N):
        s = torch.randn(5, n, generator=g)
        s[0, [n - 1, 2, n // 2]] = 10.0
        s[1] = 0.5
        s[2, [n - 1, 0]], s[2, [n - 2, 1]] = 3.0, 2.0
        s[3, torch.randperm(n, generator=g)[:7]] = 7.0
        s[4, [n - 1, n - 3, n - 5, 4, 1]] = -20.0
        got = sim.top_k(s.to(dev), 5).cpu().numpy()
        want = np.stack([np.lexsort((np.arange(n), -row))[:5] for row in s.numpy()])
        bank = torch.ones(1, n, LATENT, LATENT, 4, device=dev)
        bank[0, [n - 1, 3]] = 0.0  # two exact matches of a zero query, through K1
        _, idx = sim.retrieve(torch.zeros(2, LATENT, LATENT, 4, device=dev), bank, k=5)
        if not (np.array_equal(got, want) and idx.cpu().tolist() == [[3, n - 1, 0, 1, 2]] * 2):
            raise RuntimeError(f"top-k orders ties otherwise than jax.lax.top_k at N={n}: {got} vs {want}")
    print("  planted ties at N = 8, 26, 341 on the card: lower index first, as jax.lax.top_k")

    # (c) the fp32 eval step on the card against the CPU path
    cb = eval_batch(torch, grids[FAST_N], 2, 22)
    t0 = time.perf_counter()
    gpu = t32.eval_geodesic_step(on_device(torch, cb, dev))
    cpu = PoseConditionalTask(unet_cpu, vae_cpu, t32.config).eval_geodesic_step(
        on_device(torch, cb, torch.device("cpu")))
    match = gpu["nearest_idx"].cpu() == cpu["nearest_idx"]
    d_err = (gpu["errors_topk"].cpu() - cpu["errors_topk"]).abs()[match].max().item()
    loss_rel = abs(gpu["loss"].item() - cpu["loss"].item()) / abs(cpu["loss"].item())
    _, sim_rel = rel_err(gpu["similarity"].cpu(), cpu["similarity"])
    top1 = torch.equal(gpu["nearest_idx"][:, 0].cpu(), cpu["nearest_idx"][:, 0])
    print(f"  fp32 eval step, card vs CPU path, B=2 N={FAST_N}: top-1 {gpu['nearest_idx'][:, 0].tolist()} vs "
          f"{cpu['nearest_idx'][:, 0].tolist()}, {int(match.sum())} of 10 indices equal, errors_topk max diff "
          f"{d_err:.2e} deg (tol 1e-03), loss {gpu['loss'].item():.6f} vs {cpu['loss'].item():.6f} rel {loss_rel:.2e} "
          f"(tol 1e-04), similarity rel {sim_rel:.2e}; {time.perf_counter() - t0:.1f} s")
    if not top1 or d_err > 1e-3 or loss_rel > 1e-4 or sim_rel > CPU_SIM_RTOL:
        raise RuntimeError("the fp32 eval step on the card disagrees with the CPU path")

    # (d) serving: estimate_many, int8 banks, the registry
    refs = rng.uniform(-1, 1, (len(GALLERY), IMAGE, IMAGE, 3)).astype(np.float32)
    objects = list(GALLERY[:3])
    q8 = rng.integers(0, 256, (len(MIXED), IMAGE, IMAGE, 3), dtype=np.uint8)
    est = PoseEstimator(variant(True), fast_evaluation=True)
    est.register_objects(objects, refs[:3])
    many = est.estimate_many(list(MIXED), q8)
    worst_rel, topk_same = 0.0, True
    for oid in objects:
        rows = [i for i, o in enumerate(MIXED) if o == oid]
        one = est.estimate(oid, q8)  # the same 8 queries, so the same encodes
        _, rel = rel_err(torch.from_numpy(many.similarity[rows]), torch.from_numpy(one.similarity[rows]))
        worst_rel = max(worst_rel, rel)
        topk_same &= np.array_equal(many.nearest_idx[rows], one.nearest_idx[rows])
        if rel > TOL["float32"]["K1"] or not np.array_equal(many.nearest_idx[rows, 0], one.nearest_idx[rows, 0]):
            raise RuntimeError(f"estimate_many disagrees with estimate for {oid}")
    print(f"  estimate_many, 8 queries over 3 objects, bf16: rows vs estimate rel {worst_rel:.2e} (tol "
          f"{TOL['float32']['K1']:.0e}), top-1 equal, top-5 {'equal' if topk_same else 'differs in order'}")
    est8 = PoseEstimator(variant(True), fast_evaluation=True, bank_dtype="int8")
    est8.register_objects(objects, refs[:3])
    many8 = est8.estimate_many(list(MIXED), q8)
    q, scale = est8._banks["mug"]
    print(f"  int8 gallery: bank {tuple(q.shape)} {q.dtype} + scale {tuple(scale.shape)} {scale.dtype}; top-1 "
          f"agreement with the bf16 gallery {(many8.nearest_idx[:, 0] == many.nearest_idx[:, 0]).mean():.3f}")
    for label, e, kw in (("bf16", est, {}), ("int8", est8, {"bank_dtype": "int8"})):
        before = e.estimate_many(list(MIXED), q8)
        path = out_root / f"registry_{label}.npz"
        e.save_registry(str(path))
        fresh = PoseEstimator(variant(True), fast_evaluation=True, **kw)
        fresh.load_registry(str(path))
        after = fresh.estimate_many(list(MIXED), q8)
        bitwise = (np.array_equal(after.similarity, before.similarity)
                   and np.array_equal(after.nearest_idx, before.nearest_idx))
        print(f"  registry {label}: save ({path.stat().st_size / 2**20:.2f} MiB) -> fresh estimator -> load: "
              f"answers {'bitwise equal' if bitwise else 'DIFFER'}")
        if not bitwise:
            raise RuntimeError(f"the {label} registry does not round-trip")
    est.register_object(GALLERY[3], refs[3])
    return {"launches": launches, "half": half, "batches": batches, "chunks": chunks, "gallery": est}


def main() -> int:
    import torch
    import torch.nn.functional as F

    t_start = time.perf_counter()
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
    # the evaluation program's U-Net batches, bf16: inputs up to 2.6 GB,
    # drawn on the card; K3 at its 32x32 blocks, where M is largest
    dgen = torch.Generator(device=dev).manual_seed(2)
    big_k3 = [s for s in k3_shapes if s[0] == LATENT]
    for items in EVAL_ITEMS:
        for n in k2_tokens:
            qkv = 2 * torch.randn(items, n, 384, generator=dgen, device=dev).to(torch.bfloat16)
            got = la.linear_attention_inner(qkv, 4, 32)
            check("K2", f"items={items} n={n}", got, la.linear_attention_inner_plain(qkv.float(), 4, 32), "bfloat16")
            if not torch.equal(got, la.linear_attention_inner(qkv, 4, 32)):
                raise RuntimeError(f"K2 items={items} n={n} bfloat16: two launches on the same inputs differ")
            del qkv, got
        for shape in big_k3:
            x, emb, params = k3_inputs(torch, shape, items, dev, torch.bfloat16, dgen)
            label = f"B={items} {shape[0]}x{shape[1]} {shape[2]}->{shape[3]} res={int(shape[4])} emb={int(shape[5])}"
            got = fr.resnet_block(x, emb, params, shape[6])
            want = fr.resnet_block_plain(x.float(), None if emb is None else emb.float(),
                                         {k: v.float() for k, v in params.items()}, shape[6])
            check("K3", label, got, want, "bfloat16")
            del want
            if not torch.equal(got, fr.resnet_block(x, emb, params, shape[6])):
                raise RuntimeError(f"K3 {label}: two launches on the same inputs differ")
            del x, emb, params, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    print(f"  K3 bf16: two launches bitwise equal at all {len(k3_shapes) * len(K3_BATCHES) + len(big_k3) * len(EVAL_ITEMS)}"
          f" (shape, batch)")
    print(f"  K1 and K2, both dtypes: two launches bitwise equal at all {len(K1_SHAPES)} and "
          f"{len(K2_ITEMS) * len(k2_tokens)} shapes; K2 bf16 also at {len(EVAL_ITEMS) * len(k2_tokens)}")

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
        for b, n, lead in K1_TIMED:
            q = torch.randn(b, LATENT, LATENT, 4, generator=gen).to(dev, dtype)
            bank = torch.randn(lead, n, LATENT, LATENT, 4, generator=gen).to(dev, dtype)
            t_k = cuda_ms(torch, lambda: sim.reference_similarity(q, bank), 20, warmup=3)
            t_d = device_ms(torch, lambda: sim.reference_similarity(q, bank))
            t_p = cuda_ms(torch, lambda: sim.reference_similarity_plain(q, bank), 20, warmup=3)
            # per (query, template, pixel): 3 operations a channel, then square, sqrt, accumulate
            b1 = bound(f32_ops=float(b * n * LATENT * LATENT) * (3 * 4 + 3),
                       nbytes=float(q.numel() + bank.numel()) * q.element_size() + 4 * b * n)
            print(f"  K1 B={b:<3} N={n:<3} bank lead {lead:<3} {dn:<8} kernel {t_k:8.4f} ms (device alone {t_d:.4f}) "
                  f"plain {t_p:8.3f} ms bound {b1[0]:.4f} ms ({b1[1]}) share {100 * b1[0] / t_k:.1f}% "
                  f"(device alone {100 * b1[0] / t_d:.1f}%)")
            if (b, n) == (64, FULL_N):
                kernel_ms.setdefault("K1", (t_k, t_p, None, t_d))
                bounds.setdefault("K1", b1)
        for items in (FAST_N, FULL_N) + (EVAL_ITEMS if dtype == torch.bfloat16 else ()):
            fwd_k = fwd_d = fwd_p = fwd_b = 0.0
            for n in k2_tokens:
                count = sum(1 for c in k2_calls if c[0] == n)
                g = dgen if items in EVAL_ITEMS else gen
                qkv = (2 * torch.randn(items, n, 384, generator=g, device=g.device)).to(dev, dtype)
                t_k = cuda_ms(torch, lambda: la.linear_attention_inner(qkv, 4, 32), 20, warmup=3)
                t_d = device_ms(torch, lambda: la.linear_attention_inner(qkv, 4, 32))
                t_p = cuda_ms(torch, lambda: la.linear_attention_inner_plain(qkv, 4, 32), 10, warmup=2)
                # per (item, token, head): k^T v and q·context (2·2·dh² ops) and two softmaxes (~8·dh)
                b2 = bound(f32_ops=float(items * n * 4) * (4 * 32 * 32 + 8 * 32),
                           nbytes=float(qkv.numel() + items * n * 128) * qkv.element_size())
                fwd_k, fwd_d = fwd_k + count * t_k, fwd_d + count * t_d
                fwd_p, fwd_b = fwd_p + count * t_p, fwd_b + count * b2[0]
                print(f"  K2 items={items:<4} n={n:<4} x{count} {dn:<8} kernel {t_k:8.4f} ms (device alone "
                      f"{t_d:.4f}) plain {t_p:8.3f} ms bound {b2[0]:.4f} ms ({b2[1]}) share "
                      f"{100 * b2[0] / t_k:.1f}% (device alone {100 * b2[0] / t_d:.1f}%)")
                if (items, n) == (FAST_N, k2_tokens[0]):
                    kernel_ms.setdefault("K2", (t_k, t_p, None, t_d))
                    bounds.setdefault("K2", b2)
            print(f"  K2 the {len(k2_calls)} launches of one U-Net forward at items={items} {dn:<8} kernel "
                  f"{fwd_k:.4f} ms (device alone {fwd_d:.4f}) plain {fwd_p:.4f} ms bound {fwd_b:.4f} ms share "
                  f"{100 * fwd_b / fwd_k:.1f}% (device alone {100 * fwd_b / fwd_d:.1f}%)")
        for batch in ((FAST_N, FULL_N) + EVAL_ITEMS if dtype == torch.bfloat16 else (FAST_N,)):
            tot_k = tot_d = tot_p = tot_l = tot_h = 0.0
            work = [0.0, 0.0, 0.0]
            for shape in k3_shapes:
                x, emb, params = k3_inputs(torch, shape, batch, dev, dtype, dgen if batch in EVAL_ITEMS else gen)
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

    # -- phase 6, then the evaluation program's timings (4b) and profile (5b) --
    grids = {n: estimators[("bfloat16", n)].template_poses for n in (FAST_N, FULL_N)}
    ev = evaluation_phase(torch, dev, task32, variant, grids, counters, unet_cpu, vae_cpu, rng)
    print(f"phase 4b: timings of the evaluation program on {smi} (CUDA events after warm-up, median of 3)")
    half, eval_dev = ev["half"], {}
    for name, (b, n, _) in EVAL.items():
        chunk = ev["chunks"][name]
        db = eval_dev[name] = on_device(torch, ev["batches"][name], dev)
        q, r, rel = (db[k].to(torch.bfloat16) for k in ("query", "reference", "all_relativeR"))
        if chunk is None:
            t_bank = median_ms(torch, lambda: half.retrieval(q, half.generate_template_bank(r, rel)))
        else:
            t_bank = median_ms(torch, lambda: half.retrieve_streaming(q, r, rel, chunk))
        t_step = median_ms(torch, lambda: task32.eval_geodesic_step(db, chunk_size=chunk, infer_task=half))
        print(f"  eval {name} B={b} N={n} chunk_size {chunk} bfloat16: bank + retrieval {t_bank:9.2f} ms "
              f"{1000 * b / t_bank:7.2f} img/s; whole eval step (+ fp32 loss) {t_step:9.2f} ms "
              f"{1000 * b / t_step:7.2f} img/s [{smi}]")
    ids64 = [GALLERY[i % len(GALLERY)] for i in range(64)]
    t_many = median_ms(torch, lambda: ev["gallery"].estimate_many(ids64, q64))
    print(f"  estimate_many bfloat16 N={FAST_N} B=64 over {len(GALLERY)} objects {t_many:9.2f} ms "
          f"{64000 / t_many:7.1f} queries/s [{smi}]")
    b, n, chunk = EVAL["full"]
    print(f"phase 5b: profiler window on {smi}")
    profile_window(torch, f"eval step, full protocol B={b} N={n} chunk_size {chunk} (bf16 retrieval, fp32 loss)",
                   lambda: task32.eval_geodesic_step(eval_dev["full"], chunk_size=chunk, infer_task=half), top=10)

    table = [
        ("reference_similarity", "K1", "nope_tpu_torch/csrc/similarity.cu",
         "nope_tpu/ops/experimental/pallas_similarity.py:29", sim.reference_similarity),
        ("linear_attention_inner", "K2", "nope_tpu_torch/csrc/linear_attention.cu",
         "nope_tpu/ops/experimental/linear_attention.py:37", la.linear_attention_inner),
        ("resnet_block", "K3", "nope_tpu_torch/csrc/fused_resnet.cu",
         "nope_tpu/ops/experimental/fused_resnet.py:156", fr.resnet_block),
    ]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[fn.__name__], "max_abs_err": worst[k],
         "ms": kernel_ms[k][0], "plain_ms": kernel_ms[k][1], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": kernel_ms[k][2], "device_ms": kernel_ms[k][3],
         "eval_launches": ev["launches"][fn.__name__]}
        for name, k, src, rep, fn in table
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
