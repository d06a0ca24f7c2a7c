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
   128 x 26) and phase 11's 1,664 (64 x 26); K2 at 3, 26 and 341 items
   times each of the U-Net's token counts, and in bfloat16 at 1,984, 3,328
   and 1,664; K1 at the serving requests, B=64, a bank per query (also the
   evaluation program's (64, 31), (128, 26) and (8, 341)), a ragged B, and
   phase 11's (64, 26) shared, (32, 13) and (64, 26) per query.  Two launches on the
   same inputs must be bitwise equal (K3 bf16, K1 and K2 both dtypes).
   Past the grid's 65,535 y extent: K3 at B=65,600 (its smallest block,
   4x4; samples on both sides of 65,535 held) and K1 at B=65,600 with a
   bank per query of N=1.  K1 at other channel counts, both dtypes,
   bitwise repeatable: C = 8 (the template encoder's descriptors) at
   B=64, N=341 and with a bank per query at (64, 26); C = 12 (an odd
   number of vectors a pixel) and C = 16, shared and per query (the tiled
   kernel's shared instance); C = 3 (the scalar kernel) shared and per
   query; C = 4 over 5x5 latents (an odd pixel count: bf16 takes the
   scalar kernel).
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
   341 and with a bank per query at (64, 31) and (128, 26), and at C = 8
   at (64, 341) and (64, 26) per query; K3 per block
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

7. Refinement (``tasks.refinement``, ``refine_steps`` of ``estimate``,
   ``estimate_many`` and ``evaluate_geodesic``): (a) the gradient of the
   summed "l2" objective with respect to the pose through the kernels
   (forward) and their plain recompute (backward) against the U-Net on
   plain ops, fp32 and bf16, B = 8 and 40, with no weight gradient taken;
   K2's and K3's autograd Functions alone against autograd of their plain
   versions; (b) an fp32 refinement on the card against the CPU path;
   (c) bf16 ``estimate(refine_steps=24)`` with refine_topk 1 and 5,
   ``estimate_many`` over 4 objects and ``evaluate_geodesic`` on a
   fast-protocol batch of 16: orthonormal refined rotations, an objective
   no larger than the top-1 grid pose's, the grid outputs of the
   unrefined call; (d) ``cli.infer.run`` on uint8 arrays.
8. The ShapeNet evaluation CLI (``cli.test_shapenet.main``): writes a
   root of 2 unseen categories x 4 objects x 5 queries and 5 references
   (512-px RGBA PNGs, ``data.png.write_png``) in a temporary directory;
   requires the native library (built by g++ beside nvcc in phase 1) and
   holds its uint8 warp against the torch warp on the host, and
   ``crop_frame_torch`` on the card against the host crop; runs the CLI
   at full width in bf16 over both categories, the fast protocol whole
   (batches of 16) and the full one's first batch (chunks of 31), with
   the host's decoder and crop and again with Pillow and cv2 hidden
   (``data/png.py`` and the native warp), checking ``scores.json``, the
   dumps and every kernel's launches; runs the fp32 CLI on the card and
   on the CPU over one batch of 2 (the same top-1, loss within rel
   1e-5); and prints the loader's images/s, the decode and crop times of
   each route and the eval step's time, and from them the share of the
   CLI's wall time the card waits on the host.
9. Training (``training.train_state``, ``training.trainer``,
   ``cli.train``): (a) the gradient of one train step's loss (B=2, so a
   U-Net batch of 4) with respect to every U-Net weight, through K3 and
   K2 forward and their plain recomputes backward, against the U-Net on
   plain ops, fp32 and bf16, worst rel by grad-trace group, with every K3
   recompute asked for its weights' gradients; (b) two fp32 AdamW steps
   on the card against the CPU's from the same weights and batches
   (losses; weight deltas, see below); (c) ``cli.train.main`` at full
   width in bf16 with EMA over a training root it writes (20 steps at
   B=16, a checkpoint at 10, validation of both streams at 20), then a
   second ``main`` resumed from the step-10 checkpoint: the same batch
   stream, losses within rel 2e-2, checkpoint save and restore times,
   the ``final_params`` exports loaded by ``restore_params``, the steady
   step in the loop and peak memory; (d) one bf16 step at B=16 split into
   VAE encode, U-Net forward, backward (of which K3's and K2's plain
   recomputes) and optimizer + EMA, the same step on plain ops, the share
   of the loop's step the card waits on the host, and a profile window.
10. The parallel paths (``nope_tpu_torch.parallel``), cuDNN
   deterministic: (a) one NCCL rank in this process, a (1, 1) mesh: the
   bf16 data-parallel step at B=16 against the single-process step on the
   same batch and masters (no further apart than the single step from
   itself), both steps' times in turn, and the template-parallel
   streaming eval at N=341, B=16 against ``retrieve_streaming``; (b) two
   fresh ranks on this one card in a gloo group (``parallel_rank``; NCCL
   refuses a card twice): the fp32 data-parallel step (8 pairs a rank)
   against one process's 16 (phase 9 (b)'s measures), the bf16 step
   (the averaged gradients by group, phase 9 (a)'s tolerance), a ZeRO-1
   step against the replicated one, the streaming eval at meshes (1, 2)
   and (2, 1) (N=26, B=16) against one process, ``evaluate_geodesic`` in
   fp32 over a PNG root with each rank scoring its part of every batch
   and the scores merged, and ``cli.train.main`` on both ranks (3 bf16
   steps, a checkpoint at 2, merged validation) with a second ``main``
   resumed from the checkpoint.  Every path's launches are printed; two
   ranks sharing one card is a correctness check, not a scaling number.
11. The model zoo (``models/{ldm_unet,adm_unet,resnet,template_encoder}.py``)
   at full width, 256-px images, seeded weights (the factory's zero layers
   overwritten by seeded noise, else every template's prediction is the
   same): ``vae_cin_ldm`` from ``configs/model_ldm.yaml``,
   ``vae_guidedDiffusion`` at ``UNetConfig``'s ``gd_*`` defaults and
   ``template_base`` (ResNet-50, descriptor 8).  Each: (a) the fp32 U-Net
   and encoder on the card against the CPU at 2 items; (b) in bf16,
   registration at N=341 and ``estimate`` at B=64, N=26 through
   ``PoseEstimator`` (LDM, ADM; ``template_base`` is refused as in the JAX
   package), ``eval_geodesic_step`` at N=26 (B and chunks from
   ``ZOO_EVAL``), times, peak memory and every kernel's launches (K1 in
   all three, K2 and K3 in ``template_base`` alone); then, not counted, K1
   at each of its calls there against its plain version on the same
   inputs, and the eval step against the same step on plain ops.  The LDM also runs
   (c) ``cli.infer.main --config configs/model_ldm.yaml --fast`` over two
   PNGs with a checkpoint the port saved, against the in-process
   estimator, and (d) one bf16 train step at B=16 with ``grad_trace``.
12. The BOP / T-LESS VSD path (``cli.test_bop``, ``cli.export``,
   ``data/{base_bop,bop,objaverse}.py``, ``evaluation/{vsd,raster}.py``) at
   full width in float32, as the JAX CLI computes: (a) a procedural
   T-LESS-layout root (``write_bop_root``: 2 scenes of 4 and 5 frames x 2
   box CADs, 720x540 RGB, 8-bit masks, 16-bit depth rendered at the GT
   poses), every instance's GT-pose VSD 0; (b) ``cli.export.main`` of
   seeded reference-format weights (a ``u_net.``-keyed ``.pth`` and a
   diffusers ``.bin``) on the card, restored bitwise; (c)
   ``cli.test_bop.main`` over the root with ``--renderer numpy`` in
   batches of 4 (341 templates a query), the bank streamed in chunks of
   31 and made whole: images/s, the card's and the host VSD's time per
   batch, peak memory, K1-K3 launches, JAX's score keys, equal scores;
   K3's and K2's fp32 routes timed at 124 and 1,364 items; (d) batch 0
   against K1-K3 on their plain versions on the card and query 0 against
   the CPU path; (e) one fp32 train step each from the Objaverse and
   ``bop_texture`` loaders of ``build_train_loaders``.

Phases run in the order 1 to 6, so phases 4 and 5 time the serving
path and the kernels in a process that holds only phase 3's modules
(more live modules slow the host's side of each call); then 4b times the evaluation program (images/s of both
protocols, ``estimate_many``), 4c refinement (one refine step split into
kernels forward, backward and its plain recompute; refined ``estimate``
at B=8 against the unrefined call; a refined eval batch), 5b profiles
one full-protocol eval step and one refined ``estimate``, and phases 7
and 8, then 9, 10, 11 and 12, run.  The last two lines are the kernel table (``ms`` with the host
in the loop, ``device_ms`` on the device alone, ``launches`` of phase 3,
``eval_launches`` of phase 6 (a), ``refine_launches`` of one refined
``estimate`` in phase 7 (c), ``cli_launches`` of phase 8's two bf16 CLI
runs (fast and full protocol), ``train_launches`` and
``train_recomputes`` of phase 9's uninterrupted CLI run,
``parallel_launches`` of phase 10 (a) and (b) (both ranks),
``zoo_launches`` of phase 11 (b) by configuration, ``bop_launches``
of phase 12's two CLI runs, for K2 and K3 ``bop_fp32`` (phase 12's fp32
route times per U-Net forward at 124 and 1,364 items), and for K2 and
K3 that call's ``refine_recomputes``, their Functions'
``backward_max_rel``, the pose gradient's ``unet_pose_grad_rel`` and the
weight gradients' ``unet_weight_grad_rel`` by dtype) and
``{"ok": true, ...}``.

Weight deltas (phase 9 (b)): AdamW's first update is g/(|g|+eps), about
sign(g), so an element whose gradient is within float32 rounding of
zero may move by +lr on one device and -lr on the other.  The first
step's max|Δgpu-Δcpu|/max|Δcpu| is held on the elements whose |g| is at
least 1e-4 of their tensor's largest; both steps by the relative L2
distance and the share of elements off by more than 1e-3 of max|Δcpu|.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
# query: a full-protocol chunk, the fast protocol, estimate_many's gather;
# phase 11's: estimate at B=64 N=26, the LDM's streamed chunks of 13 at B=32,
# the ADM's eval step at B=64 N=26
K1_SHAPES = ((64, FULL_N, 1), (QUERIES, FAST_N, 1), (QUERIES, FULL_N, 1), (QUERIES, FAST_N, QUERIES), (3, FULL_N, 1),
             (64, 31, 64), (128, FAST_N, 128), (QUERIES, FULL_N, QUERIES), (64, FAST_N, 1), (32, 13, 32),
             (64, FAST_N, 64))
K1_TIMED = ((QUERIES, FAST_N, 1), (QUERIES, FULL_N, 1), (64, FAST_N, 1), (64, FULL_N, 1), (64, 31, 64),
            (128, FAST_N, 128))
# K1 at other channel counts (B, N, bank lead, C, latent side): the template encoder's descriptors (C = 8)
# at the evaluation program's B=64, N=341 and with a bank per query; the tiled kernel's shared instance at
# an odd C / 4 (C = 12: a bf16 step of 20 pixels, chunks straddling pixels) and C = 16, shared and per
# query; an odd C (the scalar kernel), shared and per query; C = 4 with an odd pixel count (25: a bf16 row
# is not 16-byte aligned, the scalar kernel)
K1_CHANNELS = ((64, FULL_N, 1, 8, 32), (64, FAST_N, 64, 8, 32), (64, FAST_N, 1, 12, 32),
               (QUERIES, FAST_N, QUERIES, 12, 32), (64, FAST_N, 1, 16, 32), (QUERIES, FAST_N, QUERIES, 16, 32),
               (QUERIES, FAST_N, 1, 3, 32), (QUERIES, FAST_N, QUERIES, 3, 32), (QUERIES, FAST_N, 1, 4, 5))
K1_TIMED_C8 = ((64, FULL_N, 1), (64, FAST_N, 64))
# the evaluation program (bench.py's two protocols): (B, N, chunk_size);
# the fast bank is made whole, the full one streamed
EVAL = {"fast": (128, FAST_N, None), "full": (64, FULL_N, 31)}
# U-Net items of one evaluation forward: a full-protocol chunk, the fast bank;
# phase 2 also holds K2 and K3 at template_base's eval step in phase 11 (B=64, N=26)
EVAL_ITEMS = (64 * 31, 128 * FAST_N)
CHECK_ITEMS = EVAL_ITEMS + (64 * FAST_N,)
# streamed against materialised in bfloat16: the top-1 is held where its
# margin over the second exceeds this share of the row's largest |score|
BF16_SIM_RTOL = 1e-2
# H100 SXM peaks (NVIDIA data sheet): bytes/s, dense bf16 tensor-core and
# float32 CUDA-core operations/s
HBM_BPS, BF16_TC_OPS, F32_OPS = 3.35e12, 989e12, 67e12
IMAGE = 256
LATENT = IMAGE // 8
# past the 65,535 a grid's y extent holds: K3's gn_silu and K1 with a bank
# per query put samples (queries) on that axis and stride beyond it
BIG_B = 65_600
# refinement (phase 7): the serving default of 24 Adam steps; multi-start
# from the top 5; gradients held against the plain U-Net as max|Δ| / max|ref|
REFINE_STEPS, REFINE_TOPK = 24, 5
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the evaluation CLI (phase 8): a procedural root of 2 unseen categories x
# 4 objects x 5 queries and 5 references, 512-px RGBA; bench-size batches
CLI_CATEGORIES, CLI_OBJECTS, CLI_VIEWS, CLI_BATCH = ("bottle", "mug"), 4, 5, 16
# the native uint8 warp against the torch warp on the host: the bound
# tests/test_native.py holds it to against cv2 (>= 99% within 1 LSB, max 4);
# the crop on the card against the host crop, images in [0, 1]: the mean
# bound of tests/test_cropping.py; the fp32 CLI, card against CPU: loss rel
NATIVE_LSB_SHARE, NATIVE_MAX_LSB, CROP_MEAN_TOL, CLI_LOSS_RTOL = 0.99, 4, 5e-3, 1e-5
# training (phase 9): a root of 2 training categories x 54 listed objects (4 in
# each category's training split) with 4 validation objects; the flagship's
# batch of 16 pairs; 20 steps, a checkpoint at 10, validation at 20
TRAIN_CATEGORIES, TRAIN_LISTED, TRAIN_VAL_OBJECTS = ("airplane", "car"), 54, 4
TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT = 16, 20, 10
# the fp32 train step on the card against the CPU's: loss rel; the weights'
# deltas from the shared start (see phase 9 (b)); the resumed bf16 run's
# losses against the uninterrupted run's
TRAIN_LOSS_RTOL, TRAIN_DELTA_RTOL, RESUME_LOSS_RTOL = 1e-5, 1e-3, 2e-2
# the parallel paths (phase 10): the global batch of 16 pairs, 8 a rank on a data
# axis of 2; streamed template chunks of 13 (26 / 2); cli.train's steps and its
# checkpoint; how long the 2-rank group may take before it is killed
PAR_BATCH, PAR_CHUNK, PAR_STEPS, PAR_CKPT, PAR_TIMEOUT = TRAIN_BATCH, 13, 3, 2, 480
# the one-rank step's cost: timed steps of each kind, in turn
PAR_ROUNDS = 8
# the model zoo (phase 11): each configuration's eval step at N=26, (B, chunk_size): the LDM's
# self-attention over 32x32 latents holds 8 x 1024² bf16 scores (16 MiB) and their softmax an item, so
# its bank streams in chunks of 13 templates (416 U-Net items); the others make the bank whole
ZOO_EVAL = {"vae_cin_ldm": (32, 13), "vae_guidedDiffusion": (64, None), "template_base": (64, None)}
ZOO_TRAIN_BATCH = 16
# the BOP / T-LESS path (phase 12): a procedural T-LESS-layout root of 2 scenes (4 and 5 frames) x 2
# box objects, 720x540 RGB-D frames at a primesense-like focal length (f ~ 1075 px); the CLI's
# batches of 4 (18 instances: the last batch holds 2), its bank streamed in chunks of 31 and made
# whole; the BOP texture group's two members and the Objaverse root for one train step each
BOP_FRAMES, BOP_OBJECTS, BOP_BATCH, BOP_CHUNK = (4, 5), 2, 4, 31
BOP_HW = (540, 720)
BOP_K = ((1075.65, 0.0, 367.07), (0.0, 1073.9, 247.72), (0.0, 0.0, 1.0))
BOP_BOXES = ((60.0, 80.0, 100.0), (90.0, 50.0, 70.0))  # CAD extents, mm
BOP_TRAIN_BATCH, OBJAVERSE_OBJECTS = 4, 2


def flagship_config():
    """The flagship configuration: the defaults the CLIs run
    (``nope_tpu_torch.configs``'s ``ModelConfig``)."""
    from nope_tpu_torch.configs import load_config

    return load_config(None).model


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


def profile_window(torch, label, fn, top=6, ranges=()):
    """Kernel time by name over one call of ``fn`` (after a warm-up), and
    the device time under each ``torch.profiler.record_function`` range
    named in ``ranges``.  Returns {wall, kernels, K3, K2, K1, <range>: ms}
    (empty when the profiler saw no kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows, spans = [], {}  # kernels only: an operator's row repeats its kernels' time
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if e.key in ranges:  # a range's span on the device's timeline, not a kernel
            spans[e.key] = (us / 1e3, e.count)
        elif us > 0:
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print(f"  profile {label}: wall {wall:.2f} ms; device time not measured (the profiler saw no kernels)")
        return {}
    own = {k: sum(r[0] for r in rows if any(name in r[2] for name in names))
           for k, names in (("K3", K3_KERNELS), ("K2", K2_KERNELS), ("K1", K1_KERNELS))}
    print(f"  profile {label}: wall {wall:.2f} ms, kernels {busy:.2f} ms ({100 * busy / wall:.1f}% of wall), "
          + ", ".join(f"{k} {ms:.3f} ms ({100 * ms / busy:.1f}%)" for k, ms in own.items()) + " of kernel time")
    for name in ranges:  # first kernel to last of each call, summed: kernels and the gaps between them
        ms, count = spans.get(name, (0.0, 0))
        print(f"    range {name!r}: x{count}, on the device " + (f"{ms:.3f} ms ({100 * ms / wall:.1f}% of wall)"
                                                                 if ms else "not measured"))
    for ms, count, name in sorted(rows, reverse=True)[:top]:
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:<4} {name[:90]}")
    return {"wall": wall, "kernels": busy, **own, **{name: spans.get(name, (0.0, 0))[0] for name in ranges}}


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


@contextlib.contextmanager
def plain_ops():
    """Every op of the U-Net on its plain version: no kernel, plain autograd."""
    from nope_tpu_torch.models import blocks
    from nope_tpu_torch.ops import fused_resnet as fr
    from nope_tpu_torch.ops import linear_attention as la

    saved = blocks.fused_resnet_block, blocks.linear_attention
    blocks.fused_resnet_block, blocks.linear_attention = fr.resnet_block_plain, la.linear_attention_inner_plain
    try:
        yield
    finally:
        blocks.fused_resnet_block, blocks.linear_attention = saved


@contextlib.contextmanager
def weight_grad_spy(torch):
    """For each K3 recompute inside a backward: whether any of the block's
    parameters asked for a gradient."""
    from nope_tpu_torch.ops import fused_resnet as fr

    asked, plain = [], fr.resnet_block_plain

    def spy(x, emb, params, groups=8, eps=1e-5):
        if torch.is_grad_enabled():
            asked.append(any(p.requires_grad for p in params.values()))
        return plain(x, emb, params, groups, eps)

    fr.resnet_block_plain = spy
    try:
        yield asked
    finally:
        fr.resnet_block_plain = plain


def pose_objective(task, r_lat, q_lat, r6):
    """(B,) "l2" refinement objective of the U-Net's prediction at pose r6."""
    from nope_tpu_torch.tasks import refinement as ref

    return ref._per_sample_objective("l2")(task.predict_latent(r_lat, r6.to(r_lat.dtype)).float(), q_lat.float())


def pose_grad(torch, task, r_lat, q_lat, r6):
    """d(Σ objective)/d(r6) with the U-Net's parameters out of the graph."""
    from nope_tpu_torch.tasks import refinement as ref

    leaf = r6.detach().clone().requires_grad_(True)
    with ref.frozen(task.unet), torch.enable_grad():
        (g,) = torch.autograd.grad(pose_objective(task, r_lat, q_lat, leaf).sum(), leaf)
    return g


def random_rotations(torch, n, seed, dev):
    from nope_tpu_torch.geometry.rotations import quaternion_to_matrix

    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return quaternion_to_matrix(torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True))).to(dev)


def top1_inits(torch, est, object_ids, result):
    """What the estimator refines from: the top-1 grid ΔR of each query,
    through the refiner's own 6d round trip (a sample that falls back
    returns exactly this)."""
    from nope_tpu_torch.geometry.rotations import matrix_to_rotation_6d, rotation_6d_to_matrix

    reps = torch.stack([est._bank_reps[o] for o in object_ids])
    idx = torch.from_numpy(result.nearest_idx[:, 0]).to(reps.device)
    return matrix_to_rotation_6d(rotation_6d_to_matrix(reps[torch.arange(len(object_ids)), idx]))


def check_refined(torch, label, est, object_ids, queries, plain, result, tol):
    """A refined estimate: the grid outputs of the unrefined call, refined
    rotations orthonormal, and an objective no larger than the top-1 grid
    pose's (within ``tol`` of it: the multi-start batch tiles the kernels
    otherwise).  Returns the worst objective ratio."""
    same = (np.array_equal(result.nearest_idx, plain.nearest_idx)
            and np.array_equal(result.similarity, plain.similarity))
    eye = np.eye(3, dtype=np.float32)
    ortho = max(np.abs(np.swapaxes(r, -1, -2) @ r - eye).max()
                for r in (result.refined_relative_rotation, result.refined_rotation))
    dets = np.linalg.det(result.refined_rotation.astype(np.float64))
    with torch.no_grad():
        q_lat = est.task.encode(est._queries(queries))
        r_lat = torch.cat([est._ref_latents[o] for o in object_ids])
        r6 = top1_inits(torch, est, object_ids, result)
        d0 = pose_objective(est.task, r_lat, q_lat, r6).cpu().numpy()
    ratio = float((result.refined_distance / d0).max())
    ok = same and ortho <= 1e-4 and (np.abs(dets - 1) <= 1e-4).all() and ratio <= 1 + tol
    print(f"  {label}: grid outputs {'equal to the unrefined call' if same else 'DIFFER'}; refined rotations "
          f"|RᵀR - I| {ortho:.2e} (tol 1e-4); objective / top-1 grid objective max {ratio:.6f} (tol 1+{tol:.0e}); "
          f"objective {result.refined_distance.mean():.6f} vs {d0.mean():.6f} mean {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"refinement {label} failed its checks")
    return ratio


def refinement_phase(torch, dev, task32, half, estimators, cpu_est, gallery, grids, requests, counters, k2_calls,
                     k3_calls, gen):
    """Phase 7: refinement on the card, full width, seeded weights.
    Returns the K2 and K3 backward checks and the refine path's launches."""
    from nope_tpu_torch.cli import infer
    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.evaluation.geodesic import evaluate_geodesic
    from nope_tpu_torch.geometry.rotations import matrix_to_rotation_6d
    from nope_tpu_torch.ops import fused_resnet as fr
    from nope_tpu_torch.ops import linear_attention as la

    print("phase 7: refinement on the card (full width, seeded random weights)")
    out = {"backward": {"K2": 0.0, "K3": 0.0}, "unet_grad": {}}
    k3_shapes = sorted(set(k3_calls), key=k3_calls.index)

    # (a) gradients through the kernels against the plain U-Net
    rng = np.random.default_rng(70)
    for dn, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        task = estimators[(dn, FAST_N)].task
        imgs = torch.from_numpy(rng.uniform(-1, 1, (80, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev, dtype)
        with torch.no_grad():
            q_lat, r_lat = task.encode(imgs[:40]), task.encode(imgs[40:])
        del imgs
        r6 = matrix_to_rotation_6d(random_rotations(torch, 40, 71, dev))
        worst = 0.0
        for b in (QUERIES, QUERIES * REFINE_TOPK):
            with weight_grad_spy(torch) as asked:
                g_k = pose_grad(torch, task, r_lat[:b], q_lat[:b], r6[:b])
            with plain_ops():
                g_p = pose_grad(torch, task, r_lat[:b], q_lat[:b], r6[:b])
            err, rel = rel_err(g_k, g_p)
            no_w = len(asked) == len(k3_calls) and not any(asked) and all(p.grad is None for p in task.unet.parameters())
            ok = rel <= GRAD_TOL[dn] and bool(torch.isfinite(g_k).all()) and no_w
            worst = max(worst, rel)
            print(f"  d(sum l2)/d(r6) B={b:<2} {dn:<8} kernels forward + plain recompute vs plain U-Net: max_abs "
                  f"{err:.3e} rel {rel:.3e} tol {GRAD_TOL[dn]:.0e}; {len(asked)} K3 recomputes, weight gradients "
                  f"asked {sum(asked)}, .grad written {sum(p.grad is not None for p in task.unet.parameters())} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"the pose gradient through the kernels disagrees ({dn}, B={b})")
        out["unet_grad"][dn] = worst
        # each op's Function alone against autograd of its plain version
        for dtype_k in (dtype,):
            for n, heads, dh in k2_calls:
                qkv = (2 * torch.randn(QUERIES, n, 3 * heads * dh, generator=gen)).to(dev, dtype_k).requires_grad_(True)
                g_out = torch.randn(QUERIES, n, heads * dh, generator=gen).to(dev, dtype_k)
                (g_k,) = torch.autograd.grad(la.linear_attention(qkv, heads, dh), qkv, g_out)
                (g_p,) = torch.autograd.grad(la.linear_attention_inner_plain(qkv, heads, dh), qkv, g_out)
                _, rel = rel_err(g_k, g_p)
                out["backward"]["K2"] = max(out["backward"]["K2"], rel)
                if rel > GRAD_TOL[dn]:
                    raise RuntimeError(f"K2's backward disagrees at n={n} {dn}: rel {rel:.3e}")
            for shape in k3_shapes:
                x, emb, params = k3_inputs(torch, shape, QUERIES, dev, dtype_k, gen)
                x.requires_grad_(True)
                leaves = [x] + ([emb.requires_grad_(True)] if emb is not None else [])
                g_out = torch.randn(QUERIES, shape[0], shape[1], shape[3], generator=gen).to(dev, dtype_k)
                got = torch.autograd.grad(fr.fused_resnet_block(x, emb, params, shape[6]), leaves, g_out)
                want = torch.autograd.grad(fr.resnet_block_plain(x, emb, params, shape[6]), leaves, g_out)
                for a, w in zip(got, want):
                    _, rel = rel_err(a, w)
                    out["backward"]["K3"] = max(out["backward"]["K3"], rel)
                    if rel > GRAD_TOL[dn]:
                        raise RuntimeError(f"K3's backward disagrees at {shape} {dn}: rel {rel:.3e}")
        print(f"  {dn}: K2's Function alone at the {len(k2_calls)} stage shapes (B={QUERIES}) and K3's at the "
              f"{len(k3_shapes)} block shapes (dx, d(emb); parameters frozen): worst rel so far "
              f"K2 {out['backward']['K2']:.3e}, K3 {out['backward']['K3']:.3e} (tol {GRAD_TOL[dn]:.0e}) ok")

    # (b) float32 refinement on the card against the CPU path
    t0 = time.perf_counter()
    q2 = requests[0][:2]
    gpu_est = estimators[("float32", FAST_N)]
    gpu = gpu_est.estimate("object", q2, refine_steps=3)
    cpu = cpu_est.estimate("object", q2, refine_steps=3)

    def kept(est, result):
        from nope_tpu_torch.geometry.rotations import rotation_6d_to_matrix

        back = rotation_6d_to_matrix(top1_inits(torch, est, ["object"] * 2, result)).cpu().numpy()
        return ~np.all(result.refined_relative_rotation == back, axis=(1, 2))

    same_top1 = np.array_equal(gpu.nearest_idx[:, 0], cpu.nearest_idx[:, 0])
    keep_g, keep_c = kept(gpu_est, gpu), kept(cpu_est, cpu)
    r_err = np.abs(gpu.refined_relative_rotation - cpu.refined_relative_rotation).max()
    d_rel = (np.abs(gpu.refined_distance - cpu.refined_distance) / np.abs(cpu.refined_distance)).max()
    ok = same_top1 and np.array_equal(keep_g, keep_c) and r_err <= 1e-3 and d_rel <= 1e-4
    print(f"  fp32 refinement, card vs CPU path, B=2 N={FAST_N} 3 steps: top-1 {'equal' if same_top1 else 'DIFFER'}, "
          f"keep-mask {keep_g.tolist()} vs {keep_c.tolist()}, refined ΔR max diff {r_err:.2e} (tol 1e-03), "
          f"distance rel {d_rel:.2e} (tol 1e-04); {time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the float32 refinement on the card disagrees with the CPU path")

    # (c) the paths, bf16: estimate (top-1 and multi-start), estimate_many, evaluate_geodesic
    est = estimators[("bfloat16", FAST_N)]
    q8 = requests[1]
    plain = est.estimate("object", q8)
    for fn in counters:
        fn.launches = 0
    fr._ResnetBlockFn.recomputes = la._LinearAttentionFn.recomputes = 0
    t0 = time.perf_counter()
    r1 = est.estimate("object", q8, refine_steps=REFINE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["launches"] = {fn.__name__: fn.launches for fn in counters}
    out["recomputes"] = {"K3": fr._ResnetBlockFn.recomputes, "K2": la._LinearAttentionFn.recomputes}
    print(f"  estimate bf16 B={QUERIES} N={FAST_N} refine_steps={REFINE_STEPS} refine_topk=1: {wall:.2f} s; launches "
          f"{out['launches']}, recompute backwards {out['recomputes']}")
    if not all(out["launches"].values()) or not all(out["recomputes"].values()):
        raise RuntimeError(f"a kernel of the refine path never ran: {out['launches']} {out['recomputes']}")
    check_refined(torch, "estimate refine_topk=1", est, ["object"] * QUERIES, q8, plain, r1, 1e-5)
    r5 = est.estimate("object", q8, refine_steps=REFINE_STEPS, refine_topk=REFINE_TOPK)
    check_refined(torch, f"estimate refine_topk={REFINE_TOPK}", est, ["object"] * QUERIES, q8, plain, r5, 1e-3)
    ids = [GALLERY[i % len(GALLERY)] for i in range(QUERIES)]
    q_many = requests[2]
    many_plain = gallery.estimate_many(ids, q_many)
    many = gallery.estimate_many(ids, q_many, refine_steps=REFINE_STEPS)
    check_refined(torch, f"estimate_many over {len(GALLERY)} objects", gallery, ids, q_many, many_plain, many, 1e-5)

    batch = eval_batch(torch, grids[FAST_N], 16, 30)
    root = ROOT / "build" / "chip_smoke" / "refine"
    scores = evaluate_geodesic(task32, [batch], refine_steps=REFINE_STEPS, save_dir=str(root), tag="fast")
    step = task32.eval_geodesic_step(on_device(torch, batch, dev), infer_task=half)  # unrefined
    with np.load(root / "pred_fast_batch0_rank0.npz") as b:
        dump = {k: b[k] for k in b.files}
    refined_R = dump["refined_R"]
    ortho = np.abs(np.swapaxes(refined_R, -1, -2) @ refined_R - np.eye(3)).max()
    same = all(np.array_equal(dump[k], step[k].cpu().numpy()) for k in ("similarity", "nearest_idx", "error_deg"))
    ok = (same and ortho <= 1e-4 and refined_R.shape == (16, 3, 3)
          and all(0 <= scores[k] <= (100 if "accuracy" in k else 180) for k in scores if k.startswith("refined")))
    print(f"  evaluate_geodesic fast protocol B=16 N={FAST_N} refine_steps={REFINE_STEPS}: grid outputs "
          f"{'equal to the unrefined step' if same else 'DIFFER'}; refined_R |RᵀR - I| {ortho:.2e}; refined "
          f"acc15 {scores['refined, accuracy_15']:.2f} acc30 {scores['refined, accuracy_30']:.2f} median "
          f"{scores['refined, median']:.2f} deg vs top1 median {scores['top1, median']:.2f}; dump keys {sorted(dump)} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the refined evaluation program failed its checks")

    # (d) the CLI's run() on uint8 arrays
    t0 = time.perf_counter()
    payload = infer.run(load_config(None), rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8),
                        rng.integers(0, 256, (2, IMAGE, IMAGE, 3), dtype=np.uint8), dev, fast=True, refine_steps=2,
                        names=["q0", "q1"])
    entry = payload["results"][1]
    ok = (payload["num_templates"] == FAST_N and len(payload["results"]) == 2
          and np.asarray(entry["refined_relative_rotation"]).shape == (3, 3)
          and np.isfinite(entry["similarity"]).all())
    print(f"  cli.infer.run on uint8 arrays (seeded weights, --fast, --refine-steps 2): {time.perf_counter() - t0:.1f} "
          f"s; num_templates {payload['num_templates']}, keys {sorted(entry)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("cli.infer.run's payload is malformed")
    return out


def refinement_timings(torch, smi, est, task32, half, requests, grids, dev):
    """Phase 4c: one refine step split into its parts, refined ``estimate``
    against the unrefined call, and a refined evaluation batch."""
    print(f"phase 4c: timings of refinement on {smi} (CUDA events after warm-up, median of 3)")
    q8 = requests[0]
    from nope_tpu_torch.geometry.rotations import matrix_to_rotation_6d
    from nope_tpu_torch.tasks import refinement as ref

    with torch.no_grad():
        q_lat = est.task.encode(est._queries(q8))
        r_lat = est._ref_latents["object"].expand(QUERIES, -1, -1, -1)
        r6 = matrix_to_rotation_6d(random_rotations(torch, QUERIES, 72, dev))

    def forward():
        with ref.frozen(est.task.unet), torch.enable_grad():
            pose_objective(est.task, r_lat, q_lat, r6.clone().requires_grad_(True)).sum()

    def step():
        pose_grad(torch, est.task, r_lat, q_lat, r6)

    def recompute():
        with plain_ops(), torch.no_grad():
            pose_objective(est.task, r_lat, q_lat, r6)

    t_fwd, t_step, t_plain = (median_ms(torch, fn) for fn in (forward, step, recompute))
    # warm-ups of one step (the same shapes as 24), then no warm-up call below
    for k in (1, REFINE_TOPK):
        est.estimate("object", q8, refine_steps=1, refine_topk=k)
    print(f"  one refine step, bf16 B={QUERIES}: {t_step:.2f} ms = kernels forward {t_fwd:.2f} ms + backward "
          f"{t_step - t_fwd:.2f} ms, of which the plain recompute (the U-Net forward on plain ops) ~{t_plain:.2f} ms "
          f"[{smi}]")
    times = {"unrefined": median_ms(torch, lambda: est.estimate("object", q8))}
    for k in (1, REFINE_TOPK):
        times[f"topk {k}"] = median_ms(
            torch, lambda: est.estimate("object", q8, refine_steps=REFINE_STEPS, refine_topk=k), warmup=0)
    print(f"  estimate bf16 B={QUERIES} N={FAST_N}: unrefined {times['unrefined']:.2f} ms; refine_steps={REFINE_STEPS} "
          f"refine_topk=1 {times['topk 1']:.2f} ms ({times['topk 1'] / times['unrefined']:.1f}x), refine_topk="
          f"{REFINE_TOPK} {times[f'topk {REFINE_TOPK}']:.2f} ms ({times[f'topk {REFINE_TOPK}'] / times['unrefined']:.1f}x) "
          f"[{smi}]")
    db = on_device(torch, eval_batch(torch, grids[FAST_N], 16, 31), dev)
    task32.eval_geodesic_step(db, refine_steps=1, infer_task=half)  # the warm-up of both
    t_off = median_ms(torch, lambda: task32.eval_geodesic_step(db, infer_task=half), warmup=0)
    t_on = median_ms(torch, lambda: task32.eval_geodesic_step(db, refine_steps=REFINE_STEPS, infer_task=half),
                     warmup=0)
    print(f"  eval step fast protocol B=16 N={FAST_N} bf16 (+ fp32 loss): unrefined {t_off:.2f} ms, refine_steps="
          f"{REFINE_STEPS} {t_on:.2f} ms ({1000 * 16 / t_on:.2f} img/s) [{smi}]")


def write_shapenet_root(root, categories=CLI_CATEGORIES, objects=CLI_OBJECTS, views=CLI_VIEWS, img_px=512, seed=0,
                        materialise=None, template_indexes=()):
    """Write a procedural ShapeNet-layout root (``nope_tpu/data/shapenet.py:5-17``)
    with the port's own PNG writer (no Pillow): ``cad_names.txt``, ``views``
    query and reference RGBA images per object (seeded colour cells with
    noise under an alpha disc) and ``object_{query,reference,template}_poses``
    at level-2 grid poses with the translation doubled, as
    ``tests/fixtures.py`` places them, 1 m in front of the camera.  With
    ``materialise`` (object ids) only those objects get images and poses;
    ``template_indexes`` adds ``templates_<idx>.png`` per object (one drawn
    image, hard-linked), which the training split reads.  Returns the
    number of queries of each category."""
    from nope_tpu_torch.data.categories import SHAPENET_CAT2ID
    from nope_tpu_torch.data.png import write_png
    from nope_tpu_torch.geometry import so3_grid

    rng = np.random.default_rng(seed)
    grid = so3_grid.load_obj_poses(2)
    root = Path(root)
    cads = [f"{SHAPENET_CAT2ID[c]}_cad{j}" for c in categories for j in range(objects)]
    root.mkdir(parents=True, exist_ok=True)
    (root / "cad_names.txt").write_text("\n".join(cads) + "\n")
    yy, xx = np.mgrid[:img_px, :img_px]
    alpha = (((yy - img_px / 2) ** 2 + (xx - img_px / 2) ** 2 <= (0.35 * img_px) ** 2) * 255).astype(np.uint8)
    templates = grid.copy()
    templates[:, :3, 3] *= 2.0

    def image():
        cells = rng.integers(0, 248, (16, 16, 3), dtype=np.uint8)
        rgb = np.repeat(np.repeat(cells, img_px // 16, 0), img_px // 16, 1)
        return np.dstack([rgb + rng.integers(0, 8, rgb.shape, dtype=np.uint8), alpha])

    for obj_id in range(len(cads)):
        if materialise is not None and obj_id not in materialise:
            continue
        name = f"obj_{obj_id:06d}"
        (root / "images" / name).mkdir(parents=True, exist_ok=True)
        for kind in ("query", "reference", "template"):
            (root / f"object_{kind}_poses").mkdir(exist_ok=True)
            poses = templates if kind == "template" else templates[rng.integers(0, len(grid), views)]
            np.save(root / f"object_{kind}_poses" / f"{name}.npy", poses)
            if kind == "template":
                continue
            for i in range(views):
                write_png(str(root / "images" / name / f"{kind}_{i:06d}.png"), image(), level=1)
        first = None
        for idx in template_indexes:
            path = root / "images" / name / f"templates_{idx:06d}.png"
            if first is None:
                write_png(str(path), image(), level=1)
                first = path
            else:
                path.hardlink_to(first)
    return objects * views


def write_bop_root(root, split="test_primesense", frames=BOP_FRAMES, hw=None, seed=0):
    """Write a procedural BOP-layout root with the port's own PNG writer
    (``nope_tpu/data/base_bop.py``'s layout): ``BOP_OBJECTS`` box CADs as
    ASCII PLY under ``models/models_cad`` (``models/models`` unless the
    root's path names tless) with ``models_info.json`` diameters, and per
    scene of ``split`` the frames' RGB, 8-bit ``mask/`` and ``mask_visib/``
    per instance, 16-bit depth in 0.1 mm, and ``scene_camera``,
    ``scene_gt`` and ``scene_gt_info``.  Every instance is a level-2 grid
    rotation with the camera well inside the upper hemisphere, turned in
    plane, 0.6-0.75 m away, the two objects side by side; the depth is
    the boxes' z-buffer (``evaluation.raster``) at their GT poses, so VSD
    of a GT pose is 0.  ``hw`` (default ``BOP_HW``) sets the frame size;
    ``BOP_K`` is a 720x540 frame's and scales with it.  Returns the
    number of instances."""
    from nope_tpu_torch.data.png import write_png
    from nope_tpu_torch.evaluation.raster import box_mesh, rasterize_depth
    from nope_tpu_torch.geometry import so3_grid

    rng = np.random.default_rng(seed)
    root = Path(root)
    h, w = hw or BOP_HW
    K = np.array(BOP_K) * np.array([[w / 720.0], [h / 540.0], [1.0]])
    cad_dir = root / "models" / ("models_cad" if "tless" in str(root) else "models")
    cad_dir.mkdir(parents=True, exist_ok=True)
    meshes, info = {}, {}
    for obj_id, extents in enumerate(BOP_BOXES[:BOP_OBJECTS], 1):
        verts, faces = meshes[obj_id] = box_mesh(extents)
        lines = ["ply", "format ascii 1.0", f"element vertex {len(verts)}", "property float x", "property float y",
                 "property float z", f"element face {len(faces)}", "property list uchar int vertex_indices",
                 "end_header"]
        lines += [" ".join(f"{x:.6f}" for x in v) for v in verts] + ["3 " + " ".join(map(str, f)) for f in faces]
        (cad_dir / f"obj_{obj_id:06d}.ply").write_text("\n".join(lines) + "\n")
        info[str(obj_id)] = {"diameter": float(np.linalg.norm(extents))}
    (cad_dir / "models_info.json").write_text(json.dumps(info))
    grid = so3_grid.load_obj_poses(2)[so3_grid.load_cam_poses(2)[:, 2, 3] >= 0.3]
    colours = rng.integers(80, 240, (BOP_OBJECTS, 3))
    count = 0
    for scene_id, n_frames in enumerate(frames, 1):
        scene = root / split / f"{scene_id:06d}"
        for sub in ("rgb", "mask", "mask_visib", "depth"):
            (scene / sub).mkdir(parents=True, exist_ok=True)
        gts, gt_infos, cams = {}, {}, {}
        for frame in range(n_frames):
            poses, depths = [], []
            for o in range(BOP_OBJECTS):
                a = rng.uniform(0, 2 * np.pi)
                pose = np.eye(4)
                pose[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]) \
                    @ grid[rng.integers(len(grid))][:3, :3]
                pose[:3, 3] = [(-1) ** o * 90.0 + rng.uniform(-10, 10), rng.uniform(-20, 20), rng.uniform(600, 750)]
                poses.append(pose)
                depths.append(rasterize_depth(*meshes[o + 1], pose, K, (h, w)))
            stack = np.stack([np.where(d > 0, d, np.inf) for d in depths])
            front = np.argmin(stack, axis=0)
            depth = np.where(np.isfinite(stack.min(0)), stack.min(0), 0.0)
            rgb = np.repeat(np.repeat(rng.integers(0, 256, (h // 12 + 1, w // 12 + 1, 3)), 12, 0), 12, 1)[:h, :w]
            gts[str(frame)], gt_infos[str(frame)] = [], []
            for o, (pose, d) in enumerate(zip(poses, depths)):
                mask, visib = d > 0, (d > 0) & (front == o)
                shade = 1.0 - (d - d[mask].min()) / max(np.ptp(d[mask]), 1e-6)
                rgb = np.where(visib[..., None], colours[o] * (0.55 + 0.45 * shade[..., None]), rgb)
                write_png(str(scene / "mask" / f"{frame:06d}_{o:06d}.png"), (mask * 255).astype(np.uint8), level=1)
                write_png(str(scene / "mask_visib" / f"{frame:06d}_{o:06d}.png"), (visib * 255).astype(np.uint8),
                          level=1)
                ys, xs = np.nonzero(mask)
                box = [int(xs.min()), int(ys.min()), int(np.ptp(xs)) + 1, int(np.ptp(ys)) + 1]
                gts[str(frame)].append({"obj_id": o + 1, "cam_R_m2c": pose[:3, :3].reshape(-1).tolist(),
                                        "cam_t_m2c": pose[:3, 3].tolist()})
                gt_infos[str(frame)].append({"bbox_obj": box, "bbox_visib": box,
                                             "visib_fract": float(visib.sum() / mask.sum())})
                count += 1
            noise = rng.integers(0, 6, rgb.shape)
            write_png(str(scene / "rgb" / f"{frame:06d}.png"), np.clip(rgb + noise, 0, 255).astype(np.uint8), level=1)
            write_png(str(scene / "depth" / f"{frame:06d}.png"), np.round(depth / 0.1).astype(np.uint16), level=1)
            cams[str(frame)] = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 0.1}
        for name, obj in (("scene_gt", gts), ("scene_gt_info", gt_infos), ("scene_camera", cams)):
            (scene / f"{name}.json").write_text(json.dumps(obj))
    return count


def write_objaverse_root(root, objects=OBJAVERSE_OBJECTS, img_px=512, seed=0):
    """Write a procedural Objaverse root (``nope_tpu/data/objaverse.py``'s
    layout) with the port's PNG writer: ``objects`` objects of 10 RGBA
    renders (seeded colour cells under an alpha disc) and their
    ``object_poses`` at level-2 grid rotations 1 m away.  Returns the
    number of images."""
    from nope_tpu_torch.data.png import write_png
    from nope_tpu_torch.geometry import so3_grid

    rng = np.random.default_rng(seed)
    root = Path(root)
    grid = so3_grid.load_obj_poses(2)
    yy, xx = np.mgrid[:img_px, :img_px]
    alpha = (((yy - img_px / 2) ** 2 + (xx - img_px / 2) ** 2 <= (0.35 * img_px) ** 2) * 255).astype(np.uint8)
    (root / "object_poses").mkdir(parents=True, exist_ok=True)
    for obj in range(objects):
        name = f"obj_{obj:06d}"
        (root / "images" / name).mkdir(parents=True, exist_ok=True)
        poses = grid[rng.integers(0, len(grid), 10)].copy()
        poses[:, :3, 3] *= 2.0
        np.save(root / "object_poses" / f"{name}.npy", poses)
        for k in range(10):
            cells = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
            rgb = np.repeat(np.repeat(cells, img_px // 16, 0), img_px // 16, 1)
            write_png(str(root / "images" / name / f"{k}.png"), np.dstack([rgb, alpha]), level=1)
    return objects * 10


def write_training_root(root):
    """A root for the training CLI: ``TRAIN_CATEGORIES`` x ``TRAIN_LISTED``
    objects listed; the training split's (the last ``TRAIN_LISTED`` - 50 of
    each category's seeded shuffle) and the first ``TRAIN_VAL_OBJECTS`` of
    the validation split's are written, with the level-2 template images
    the training split reads as references.  Returns (training items,
    validation items)."""
    from nope_tpu_torch.data.categories import SHAPENET_CAT2ID
    from nope_tpu_torch.data.shapenet import ShapeNetDataset
    from nope_tpu_torch.geometry import so3_grid

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    (root / "cad_names.txt").write_text(
        "\n".join(f"{SHAPENET_CAT2ID[c]}_cad{j}" for c in TRAIN_CATEGORIES for j in range(TRAIN_LISTED)) + "\n")

    class Probe(ShapeNetDataset):
        def _load_metadata(self):
            self.selected = self._selected_object_ids()
            self.query_paths = []

    train = list(Probe(str(root), split="training").selected)
    val = list(Probe(str(root), split="unseen_training").selected[:TRAIN_VAL_OBJECTS])
    train_idx, _ = so3_grid.get_obj_poses_from_template_level(2, "upper", return_index=True)
    write_shapenet_root(root, TRAIN_CATEGORIES, TRAIN_LISTED, CLI_VIEWS, materialise=set(train + val),
                        template_indexes=train_idx, seed=9)
    return len(train) * CLI_VIEWS, len(val) * CLI_VIEWS


def cli_phase(torch, dev, smi, counters, task32, half, native_build):
    """Phase 8: ``cli.test_shapenet.main`` on the card over a root written
    here; the native warp and the crop on the card checked first; then the
    input pipeline's times beside the eval step's.  Returns the kernels'
    launches over the two bf16 CLI runs."""
    import importlib.util
    import io
    import tempfile

    from nope_tpu_torch import native
    from nope_tpu_torch.cli import test_shapenet
    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.data.builder import build_dataset
    from nope_tpu_torch.data.pipeline import DataLoader
    from nope_tpu_torch.data.shapenet import SHAPENET_INTRINSIC, ShapeNetDataset, decode_png, decoder
    from nope_tpu_torch.evaluation.geodesic import _to_device
    from nope_tpu_torch.geometry import cropping
    from nope_tpu_torch.ops import fused_resnet as fr

    print("phase 8: the ShapeNet evaluation CLI (cli.test_shapenet.main) over a PNG root written here")
    with tempfile.TemporaryDirectory(prefix="nope_shapenet_") as tmp:
        tmp = Path(tmp)
        root = tmp / "shapenet"
        t0 = time.perf_counter()
        per_cat = write_shapenet_root(root)
        pngs = sorted(root.glob("images/*/*.png"))
        print(f"  root: {len(CLI_CATEGORIES)} categories x {CLI_OBJECTS} objects x {CLI_VIEWS} queries + "
              f"{CLI_VIEWS} references, 512-px RGBA, {len(pngs)} PNGs "
              f"({sum(p.stat().st_size for p in pngs) / 2**20:.1f} MiB) written by png.write_png in "
              f"{time.perf_counter() - t0:.2f} s")

        # (a) the host routes: the decoder, the native warp (required here) and the crop
        lib = native_build.result()  # a failed g++ build fails the phase
        if not native.available():
            raise RuntimeError("the native library did not load: phase 8 runs the native warp")
        crop_route = "cv2" if importlib.util.find_spec("cv2") else "native"
        print(f"  host routes: PNG decode {decoder()}, crop {crop_route}; native library "
              f"{Path(lib).relative_to(ROOT)}")
        ds = ShapeNetDataset(str(root), CLI_CATEGORIES[0], img_size=IMAGE)
        paths = ds.query_paths[:4]
        rgbs = [ds.open_image(p) for p in paths]
        poses = [ds.get_pose(p) for p in paths]
        homs = [cropping.crop_homography(SHAPENET_INTRINSIC, pose, IMAGE, virtual_bbox_size=1.0) for pose in poses]
        diffs = []
        for rgb, M in zip(rgbs, homs):
            want = cropping.warp_perspective_torch(torch.from_numpy(rgb.astype(np.float32)), torch.from_numpy(M),
                                                   IMAGE).numpy()
            want = np.clip(np.rint(want), 0, 255).astype(np.uint8)
            diffs.append(np.abs(native.warp_perspective(rgb, M, IMAGE).astype(int) - want))
        d = np.stack(diffs)
        share = float(np.mean(d <= 1))
        ok = share >= NATIVE_LSB_SHARE and d.max() <= NATIVE_MAX_LSB
        print(f"  native uint8 warp vs the torch warp (host, rounded), {len(rgbs)} x 512 -> {IMAGE}: "
              f"{share:.5f} of pixels within 1 LSB (tol {NATIVE_LSB_SHARE}), max {d.max()} (tol {NATIVE_MAX_LSB}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the native warp disagrees with the torch warp")
        imgs = np.stack(rgbs).astype(np.float32) / 255.0
        on_card = cropping.crop_frame_torch(torch.from_numpy(imgs).to(dev), torch.from_numpy(SHAPENET_INTRINSIC),
                                            torch.from_numpy(np.stack(poses)).to(dev), IMAGE, 1.0)
        host = np.stack([cropping.crop_frame(img, None, SHAPENET_INTRINSIC, pose, IMAGE, virtual_bbox_size=1.0)
                         for img, pose in zip(imgs, poses)])
        means = np.abs(on_card.cpu().numpy() - host).mean(axis=(1, 2, 3))
        ok = on_card.device == dev and means.max() < CROP_MEAN_TOL
        print(f"  crop_frame_torch on the card vs crop_frame on the host ({crop_route}), {len(imgs)} images in "
              f"[0, 1]: mean |diff| per image max {means.max():.3e} (tol {CROP_MEAN_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the crop on the card disagrees with the host crop")

        # (b) the CLI in bf16 over both categories: the fast protocol whole, the full one's first batch
        data = [f"data.datasets.shapeNet.root_dir={root}"]

        def run(label, flags, overrides, expect_images, expect_batches, n):
            save = tmp / label
            for fn in counters:
                fn.launches = 0
            fr.resnet_block.tensor_core_launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                results = test_shapenet.main([*flags, *data, *overrides, f"save_dir={save}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counters}
            launches["resnet_block tensor cores"] = fr.resnet_block.tensor_core_launches
            cats = [c for c in results if c != "mean"]
            written = json.loads((save / "train" / "scores.json").read_text())
            dumps = sorted(p.name for p in (save / "train" / "predictions").glob("*.npz"))
            want_dumps = sorted(f"pred_{c}_batch{i}_rank0.npz" for c in cats for i in range(expect_batches))
            ok = written == results and dumps == want_dumps and all(launches.values())
            for cat in cats:
                sc = results[cat]
                ok &= (sc["num_images"] == expect_images and all(np.isfinite(v) for v in sc.values())
                       and all(0 <= v <= (100 if "accuracy" in k else 180) for k, v in sc.items()
                               if k.startswith("top")))
                with np.load(save / "train" / "predictions" / f"pred_{cat}_batch0_rank0.npz") as dump:
                    b = len(dump["query_pose"])
                    ok &= (dump["similarity"].shape == (b, n) and dump["nearest_idx"].shape == (b, 5)
                           and ((dump["nearest_idx"] >= 0) & (dump["nearest_idx"] < n)).all()
                           and dump["error_deg"].shape == (b,))
                print(f"  {label} {cat}: {sc['num_images']:.0f} images, {sc['images_per_sec']:.2f} img/s; loss "
                      f"{sc['loss']:.6f}, top1 acc15 {sc['top1, accuracy_15']:.2f}, top5 acc30 "
                      f"{sc['top5, accuracy_30']:.2f}, top1 median {sc['top1, median']:.2f} deg [{smi}]")
            print(f"  {label}: {wall:.2f} s in main; categories {cats}; {len(dumps)} dumps; launches {launches} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok or cats != list(CLI_CATEGORIES):
                raise RuntimeError(f"the CLI's {label} run failed its checks: {results}")
            return results, wall, launches

        both = ["--categories", ",".join(CLI_CATEGORIES)]
        fast, _, fast_launches = run(
            "fast", both, [f"machine.batch_size={CLI_BATCH}"], per_cat, -(-per_cat // CLI_BATCH), FAST_N)
        full, _, full_launches = run(
            "full", [*both, "--chunk-size", "31", "--max-batches", "1"],
            [f"machine.batch_size={CLI_BATCH}", "data.datasets.shapeNet.fast_evaluation=false"],
            CLI_BATCH, 1, FULL_N)
        launches = {k: fast_launches[k] + full_launches[k] for k in fast_launches}
        with hidden("PIL", "cv2"):  # a host without them: png.py decodes, the native warp crops
            lean, _, _ = run("fast without Pillow and cv2", both, [f"machine.batch_size={CLI_BATCH}"], per_cat,
                             -(-per_cat // CLI_BATCH), FAST_N)

        # (c) the fp32 CLI, card against CPU, one batch of 2
        fp32 = ["model.testing_config.half_precision_eval=false", "machine.batch_size=2"]
        one = ["--categories", CLI_CATEGORIES[0], "--max-batches", "1"]
        t0 = time.perf_counter()
        outs = {}
        for device in ("cuda", "cpu"):
            save = tmp / f"fp32_{device}"
            with contextlib.redirect_stdout(io.StringIO()):
                scores = test_shapenet.main([*one, "--device", device, *data, *fp32, f"save_dir={save}"])
            with np.load(save / "train" / "predictions" / f"pred_{CLI_CATEGORIES[0]}_batch0_rank0.npz") as dump:
                outs[device] = (scores[CLI_CATEGORIES[0]]["loss"], dump["nearest_idx"], dump["similarity"])
        (gl, gi, gs), (cl, ci, cs) = outs["cuda"], outs["cpu"]
        loss_rel = abs(gl - cl) / abs(cl)
        _, sim_rel = rel_err(torch.from_numpy(gs), torch.from_numpy(cs))
        ok = np.array_equal(gi[:, 0], ci[:, 0]) and loss_rel <= CLI_LOSS_RTOL
        print(f"  fp32 CLI, card vs CPU, B=2 N={FAST_N} through the reader: top-1 {gi[:, 0].tolist()} vs "
              f"{ci[:, 0].tolist()}, top-5 {'equal' if np.array_equal(gi, ci) else 'differs'}, loss {gl:.6f} vs "
              f"{cl:.6f} rel {loss_rel:.2e} (tol {CLI_LOSS_RTOL:.0e}), similarity rel {sim_rel:.2e}; "
              f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the fp32 CLI on the card disagrees with the CPU path")

        # (d) the input pipeline's times beside the eval step's, with the host's routes and without Pillow and cv2
        cfg = load_config(None, data)  # the dataset entry and the loader threads the CLI runs with

        def load_all():
            dataset = build_dataset(dataclasses.replace(cfg.data.datasets["shapeNet"], split=CLI_CATEGORIES[0]))
            loader = DataLoader(dataset, batch_size=CLI_BATCH, shuffle=False, drop_last=False,
                                num_workers=cfg.machine.num_workers)
            t0 = time.perf_counter()
            batches = list(loader)
            return batches, len(dataset) / (time.perf_counter() - t0)

        files = [p for p in pngs if p.name.startswith("query_")][:per_cat]
        batches, rate = load_all()
        t_decode = median_host_ms([lambda p=p: decode_png(str(p)) for p in files])
        t_crop = median_host_ms([lambda r=r, q=q: cropping.crop_frame(r, None, SHAPENET_INTRINSIC, q, IMAGE,
                                                                      virtual_bbox_size=1.0)
                                 for r, q in zip(rgbs, poses)])
        with hidden("PIL", "cv2"):
            lean_batches, lean_rate = load_all()
            t_png = median_host_ms([lambda p=p: decode_png(str(p)) for p in files])
            t_native = median_host_ms([lambda r=r, q=q: cropping.crop_frame(r, None, SHAPENET_INTRINSIC, q, IMAGE,
                                                                             virtual_bbox_size=1.0)
                                       for r, q in zip(rgbs, poses)])
        same = all(np.array_equal(a["query_pose"], b["query_pose"]) for a, b in zip(batches, lean_batches))
        crop_diff = max(float(np.abs(a["query"] - b["query"]).max()) for a, b in zip(batches, lean_batches))
        # Average and Paeth rows unfilter in a Python loop (data/png.py): one image with every row Paeth
        from nope_tpu_torch.data.png import read_png, write_png

        write_png(str(tmp / "paeth.png"), read_png(str(files[0])), filter_type=4)
        t_paeth = median_host_ms([lambda: read_png(str(tmp / "paeth.png"))])
        db = _to_device(batches[0], dev)
        t_step = median_ms(torch, lambda: task32.eval_geodesic_step(db, infer_task=half))
        print(f"  timings on {smi} (host clocks; the eval step by CUDA events, median of 3):")
        print(f"    loader alone ({len(batches)} batches of <= {CLI_BATCH}, {cfg.machine.num_workers} threads, no "
              f"model): {rate:.2f} img/s with {decoder()} + {crop_route}, {lean_rate:.2f} img/s with png.py + "
              f"native (Pillow and cv2 hidden; the same items, crops within {crop_diff * 127.5:.2f} LSB"
              f"{'' if same else ', ORDER DIFFERS'}) [{smi}]")
        print(f"    PNG decode per 512-px RGBA image (filter None): {decoder()} {t_decode:.2f} ms, png.py {t_png:.2f} "
              f"ms; png.py with every row Paeth-filtered {t_paeth:.2f} ms; crop 512 -> {IMAGE}: {crop_route} "
              f"{t_crop:.2f} ms, native {t_native:.2f} ms [{smi}]")
        print(f"    eval step alone, fast protocol B={CLI_BATCH} N={FAST_N} bf16 (+ fp32 loss): {t_step:.2f} ms "
              f"[{smi}]")
        for label, runs in (("host routes", fast), ("png.py + native", lean)):
            warm = runs[CLI_CATEGORIES[-1]]
            cli_ms = 1000 * warm["num_images"] / warm["images_per_sec"]
            busy_ms = len(batches) * t_step
            print(f"    CLI fast protocol ({label}), {CLI_CATEGORIES[-1]}: {cli_ms:.2f} ms for {warm['num_images']:.0f} "
                  f"images in {len(batches)} batches against {busy_ms:.2f} ms of eval steps: the card waits on the "
                  f"host {100 * max(0.0, 1 - busy_ms / cli_ms):.1f}% of the CLI's wall time [{smi}]")
        for cat in CLI_CATEGORIES:
            print(f"    CLI images/s, {cat}: fast {fast[cat]['images_per_sec']:.2f} (png.py + native "
                  f"{lean[cat]['images_per_sec']:.2f}), full (first batch, chunks of 31) "
                  f"{full[cat]['images_per_sec']:.2f} [{smi}]")
        if not same:
            raise RuntimeError("the loader's batches differ without Pillow and cv2")
    return launches


class _NoUpdate:
    """The optimizer seat of a train state that only clears gradients: a
    train step with it leaves the weights as they were and the gradients
    in ``.grad``."""

    def __init__(self, params):
        self.params = list(params)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        return True


def train_pairs(torch, b, seed):
    """One dataset's batch of ``b`` training pairs on the uint8 wire: seeded
    images, a seeded ΔR and its inverse (6d)."""
    from nope_tpu_torch.geometry.rotations import matrix_to_rotation_6d

    rng = np.random.default_rng(seed)
    mats = random_rotations(torch, b, seed, "cpu")
    return {"query": rng.integers(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8),
            "reference": rng.integers(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8),
            "relativeR": matrix_to_rotation_6d(mats).numpy(),
            "relativeR_inv": matrix_to_rotation_6d(mats.transpose(-1, -2)).numpy()}


def weight_grads(torch, task, batches, half):
    """d(train loss)/d(every U-Net parameter) of one train step, through
    whatever ops the U-Net runs; the weights stay as they are."""
    from nope_tpu_torch.training import train_state

    state = train_state.TrainState(0, task.unet, task.vae, _NoUpdate(task.unet.parameters()))
    _, metrics = train_state.make_train_step(task, half_precision=half)(state, batches)
    grads = {n: p.grad for n, p in task.unet.named_parameters()}
    state.opt.zero_grad()
    return grads, float(metrics["loss/train_avg"])


@contextlib.contextmanager
def timed_recomputes(torch):
    """CUDA events and a profiler range ("K3 plain recompute", "K2 plain
    recompute") around each backward of K3's and K2's autograd Functions."""
    from nope_tpu_torch.ops import fused_resnet as fr
    from nope_tpu_torch.ops import linear_attention as la

    spans, saved = {"K3": [], "K2": []}, {}
    for k, fn_cls in (("K3", fr._ResnetBlockFn), ("K2", la._LinearAttentionFn)):
        real = saved[fn_cls] = fn_cls.__dict__["backward"]

        def wrapped(ctx, *grads, _real=real.__func__, _k=k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(f"{_k} plain recompute"):
                start.record()
                out = _real(ctx, *grads)
                end.record()
            spans[_k].append((start, end))
            return out

        fn_cls.backward = staticmethod(wrapped)
    try:
        yield spans
    finally:
        for fn_cls, real in saved.items():
            fn_cls.backward = real


def span_ms(torch, spans):
    torch.cuda.synchronize()
    return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}


def training_phase(torch, dev, smi, counters, task32, unet_cpu, vae_cpu, per_forward):
    """Phase 9: training at full width.  ``per_forward``: K3's and K2's
    launches in one U-Net forward.  Returns the kernels' launches and
    recomputes over the CLI's uninterrupted run, the weight gradients'
    worst rel in each dtype and the step's timings."""
    import tempfile

    from nope_tpu_torch.cli import train as train_cli
    from nope_tpu_torch.data import pipeline
    from nope_tpu_torch.data.shapenet import ShapeNetDataset
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.ops import fused_resnet as fr
    from nope_tpu_torch.ops import linear_attention as la
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask
    from nope_tpu_torch.training import checkpoint, optim, train_state
    from nope_tpu_torch.training.checkpoint import CheckpointManager

    print("phase 9: training on the card (full width, seeded random weights)")
    out = {"grad": {}}
    groups = train_state._grad_trace_groups(task32.unet)

    # (a) weight gradients through K3, K2 and their recompute backwards against the plain U-Net
    batches = {"ds": train_pairs(torch, 2, 90)}
    for dn, half in (("float32", False), ("bfloat16", True)):
        before = (fr.resnet_block.launches, la.linear_attention_inner.launches)
        with weight_grad_spy(torch) as asked:
            g_k, loss_k = weight_grads(torch, task32, batches, half)
        fwd = (fr.resnet_block.launches - before[0], la.linear_attention_inner.launches - before[1])
        with plain_ops():
            g_p, loss_p = weight_grads(torch, task32, batches, half)
        rels = {}
        for grp in train_state.GRAD_TRACE_GROUPS:
            names = [n for n, g in groups.items() if g == grp]
            num = max(float((g_k[n].float() - g_p[n].float()).abs().max()) for n in names)
            rels[grp] = num / max(float(g_p[n].float().abs().max()) for n in names)
        worst = max(rels.values())
        finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
        ok = worst <= GRAD_TOL[dn] and finite and len(asked) == per_forward[0] and all(asked) and fwd == per_forward
        print(f"  d(train loss)/d(U-Net weights) B=2 (U-Net batch 4) {dn:<8} kernels forward + plain recompute vs "
              f"plain U-Net: worst rel by group " + ", ".join(f"{g} {r:.3e}" for g, r in rels.items())
              + f" (tol {GRAD_TOL[dn]:.0e}); loss {loss_k:.6f} vs {loss_p:.6f}; forward K3 x{fwd[0]} K2 x{fwd[1]}; "
              f"{len(asked)} K3 recomputes, each asked for its weight gradients: {all(asked)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"the weight gradients through the kernels disagree ({dn})")
        out["grad"][dn] = worst
        del g_k, g_p

    # (b) two fp32 AdamW steps on the card against the CPU's, from the same weights and batches
    def two_steps(unet, vae):
        task = PoseConditionalTask(unet, vae, task32.config)
        opt = optim.make_optimizer(unet.parameters(), base_lr=1e-4, warm_up_steps=0)
        state = train_state.TrainState(0, unet, vae, opt)
        step = train_state.make_train_step(task)
        start = {n: p.detach().clone() for n, p in unet.named_parameters()}
        losses, deltas, first = [], [], None
        for seed in (91, 92):
            state, m = step(state, {"ds": train_pairs(torch, 2, seed)})
            if first is None:
                first = {n: p.grad.detach().cpu() for n, p in unet.named_parameters()}
            losses.append(float(m["loss/train_avg"]))
            deltas.append({n: (p.detach() - start[n]).cpu() for n, p in unet.named_parameters()})
        return losses, deltas, first

    t0 = time.perf_counter()
    gl, gd, _ = two_steps(copy.deepcopy(task32.unet), task32.vae)
    cl, cd, cfirst = two_steps(copy.deepcopy(unet_cpu), vae_cpu)
    # AdamW's first update is g/(|g|+eps), about sign(g): elements whose gradient is within float32
    # rounding of zero may take either sign on either device, so the first step's max is held on the
    # elements whose |g| is at least 1e-4 of their tensor's largest; both steps by the relative L2 distance
    keep = {n: g.abs() >= 1e-4 * g.abs().max() for n, g in cfirst.items()}
    kept = sum(int(m.sum()) for m in keep.values()) / sum(m.numel() for m in keep.values())
    top1 = max(float(d.abs().max()) for d in cd[0].values())
    step1 = max(float((gd[0][n] - cd[0][n]).abs()[keep[n]].max()) for n in keep) / top1
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    ok = loss_rel <= TRAIN_LOSS_RTOL and step1 <= TRAIN_DELTA_RTOL and kept >= 0.99
    l2s, shares, raw = [], [], []
    for a, b in zip(gd, cd):
        diff = torch.cat([(a[n] - b[n]).reshape(-1) for n in b])
        ref = torch.cat([b[n].reshape(-1) for n in b])
        l2s.append(float(diff.norm() / ref.norm()))
        shares.append(float((diff.abs() > TRAIN_DELTA_RTOL * ref.abs().max()).float().mean()))
        raw.append(float(diff.abs().max() / ref.abs().max()))
    ok &= max(l2s) <= TRAIN_DELTA_RTOL and max(shares) <= TRAIN_DELTA_RTOL
    print(f"  fp32 train step, card vs CPU, 2 AdamW steps (lr 1e-4, warm_up_steps=0) at B=2: losses "
          f"{[round(x, 7) for x in gl]} vs {[round(x, 7) for x in cl]} rel {loss_rel:.2e} (tol {TRAIN_LOSS_RTOL:.0e}); "
          f"weight deltas: step 1 max|Δgpu-Δcpu|/max|Δcpu| {step1:.2e} over the {100 * kept:.3f}% of elements "
          f"whose |g| >= 1e-4 of their tensor's max (tol {TRAIN_DELTA_RTOL:.0e}); relative L2 by step "
          f"{[f'{x:.2e}' for x in l2s]}, share of elements off by > 1e-3 of max|Δcpu| {[f'{x:.1e}' for x in shares]}"
          f" (tol {TRAIN_DELTA_RTOL:.0e}); unmasked max rel {[f'{x:.2e}' for x in raw]}; "
          f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the fp32 train step on the card disagrees with the CPU's")
    del gd, cd, cfirst

    # (c) cli.train.main at full width in bf16 over a training root, then a resume from its step-10 checkpoint
    with tempfile.TemporaryDirectory(prefix="nope_train_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        n_train, n_val = write_training_root(tmp / "root")
        print(f"  training root: {len(TRAIN_CATEGORIES)} categories x {TRAIN_LISTED} listed objects, {n_train} "
              f"training queries, {n_val} validation queries, 512-px RGBA, written in {time.perf_counter() - t0:.2f} s")
        fetched = []  # (epoch, index) of each training batch, in fetch order
        real_item, real_collate = ShapeNetDataset.__getitem__, pipeline.collate

        def item(self, index):
            it = real_item(self, index)
            if self.split == "training":
                it["_idx"] = np.asarray([self._epoch, index], np.int64)
            return it

        def collate(items):
            batch = real_collate(items)
            if "_idx" in batch:
                fetched.append(batch.pop("_idx").tolist())
            return batch

        saves, restores = [], []
        real_save, real_restore = CheckpointManager.save, CheckpointManager.restore_with_ema
        resume_dir = tmp / "b" / "train" / "checkpoints"

        def timed_save(self, step, state, force=False, ema_params=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            done = real_save(self, step, state, force, ema_params)
            if done:
                path = Path(self._path(step))
                saves.append((step, time.perf_counter() - t, path.stat().st_size))
                if step == TRAIN_CKPT and resume_dir not in path.parents:
                    resume_dir.mkdir(parents=True, exist_ok=True)
                    os.link(path, resume_dir / path.name)  # the resumed run's start; survives keep_checkpoints=1
            return done

        def timed_restore(self, state, ema_params, step=None):
            t = time.perf_counter()
            got = real_restore(self, state, ema_params, step)
            torch.cuda.synchronize()
            restores.append(time.perf_counter() - t)
            return got

        common = [f"data.datasets.shapeNet.root_dir={tmp / 'root'}", "model.optim_config.half_precision_train=true",
                  "model.optim_config.ema_decay=0.999", f"machine.batch_size={TRAIN_BATCH}",
                  "trainer.keep_checkpoints=1", f"trainer.val_check_interval={TRAIN_STEPS}",
                  "trainer.media_every_n_steps=0", "trainer.num_sanity_val_steps=0", "trainer.log_every_n_steps=1",
                  "name_exp=train"]
        ShapeNetDataset.__getitem__, pipeline.collate = item, collate
        CheckpointManager.save, CheckpointManager.restore_with_ema = timed_save, timed_restore
        try:
            for fn in counters:
                fn.launches = 0
            fr._ResnetBlockFn.recomputes = la._LinearAttentionFn.recomputes = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state_a, trainer_a = train_cli.main(["--max-steps", str(TRAIN_STEPS), *common, f"save_dir={tmp / 'a'}",
                                                 f"trainer.checkpoint_every_n_steps={TRAIN_CKPT}"])
            torch.cuda.synchronize()
            wall_a = time.perf_counter() - t0
            out["launches"] = {fn.__name__: fn.launches for fn in counters}
            out["recomputes"] = {"K3": fr._ResnetBlockFn.recomputes, "K2": la._LinearAttentionFn.recomputes, "K1": 0}
            peak = torch.cuda.max_memory_allocated() / 2**30
            log_a, fetched[:] = list(fetched), []
            # the resumed run saves no checkpoint of its own (its interval is past its steps)
            t0 = time.perf_counter()
            state_b, _ = train_cli.main(["--max-steps", str(TRAIN_STEPS), *common, f"save_dir={tmp / 'b'}",
                                         f"trainer.checkpoint_every_n_steps={10 * TRAIN_STEPS}"])
            torch.cuda.synchronize()
            wall_b = time.perf_counter() - t0
            log_b = list(fetched)
        finally:
            ShapeNetDataset.__getitem__, pipeline.collate = real_item, real_collate
            CheckpointManager.save, CheckpointManager.restore_with_ema = real_save, real_restore
        rec_a = [json.loads(x) for x in open(tmp / "a" / "train" / "metrics.jsonl")]
        rec_b = [json.loads(x) for x in open(tmp / "b" / "train" / "metrics.jsonl")]
        loss_a = {r["step"]: r["loss/train_avg"] for r in rec_a if "loss/train_avg" in r}
        loss_b = {r["step"]: r["loss/train_avg"] for r in rec_b if "loss/train_avg" in r}
        val_a = [r for r in rec_a if any(k.startswith("val_ema/") for k in r)]
        resumed = sorted(loss_b) == list(range(TRAIN_CKPT + 1, TRAIN_STEPS + 1))
        worst = max(abs(loss_b[s] - loss_a[s]) / abs(loss_a[s]) for s in loss_b) if resumed else float("inf")
        same_stream = log_b[:TRAIN_STEPS - TRAIN_CKPT] == log_a[TRAIN_CKPT:TRAIN_STEPS]
        probe = build_task(flagship_config(), dev, torch.Generator().manual_seed(1))
        exports = tmp / "a" / "train" / "checkpoints"
        loaded = True
        for name, unet in (("final_params.pth", state_a.unet), ("final_params_ema.pth", trainer_a.ema_params)):
            checkpoint.restore_params(str(exports / name), probe)
            loaded &= all(torch.equal(a, b) for a, b in zip(probe.unet.state_dict().values(),
                                                            unet.state_dict().values()))
        export_gb = sum((exports / n).stat().st_size for n in ("final_params.pth", "final_params_ema.pth")) / 1e9
        rates = [r["steps_per_sec"] for r in rec_a if "steps_per_sec" in r and r["step"] > 1]
        step_ms = 1000 / float(np.median(rates))
        ok = (all(out["launches"].values()) and all(np.isfinite(list(loss_a.values()))) and len(loss_a) == TRAIN_STEPS
              and state_a.step == state_b.step == TRAIN_STEPS and resumed and worst <= RESUME_LOSS_RTOL and same_stream
              and len(val_a) == 1 and [s for s, _, _ in saves] == [TRAIN_CKPT, TRAIN_STEPS] and len(restores) == 1
              and loaded)
        print(f"  cli.train.main bf16, EMA 0.999, B={TRAIN_BATCH}: {TRAIN_STEPS} steps in {wall_a:.2f} s of main "
              f"(checkpoints at {[s for s, _, _ in saves]}, validation at {TRAIN_STEPS} on both streams: "
              f"{sorted(k for k in val_a[0] if k.endswith('top1, accuracy_15')) if val_a else 'MISSING'}); launches "
              f"{out['launches']}, recomputes {out['recomputes']}; loss {loss_a[1]:.5f} -> {loss_a[TRAIN_STEPS]:.5f}")
        print(f"  resumed from step {TRAIN_CKPT} by a second main ({wall_b:.2f} s): batch (epoch, index) stream "
              f"{'equal to' if same_stream else 'DIFFERS from'} the uninterrupted run's over steps "
              f"{TRAIN_CKPT + 1}-{TRAIN_STEPS}; losses worst rel {worst:.3e} (tol {RESUME_LOSS_RTOL:.0e})")
        print(f"  steady step in the loop (median of steps 2-{TRAIN_STEPS}, host clocks, a metric read every step): "
              f"{step_ms:.2f} ms, {1000 / step_ms:.3f} steps/s, {TRAIN_BATCH * 1000 / step_ms:.2f} training pairs/s; "
              f"peak memory {peak:.2f} GiB [{smi}]")
        print(f"  checkpoints: save " + ", ".join(f"step {s} {t:.2f} s {b / 1e9:.3f} GB" for s, t, b in saves)
              + f"; restore {restores[0] if restores else float('nan'):.2f} s; final_params + final_params_ema "
              f"{export_gb:.3f} GB, loaded by restore_params bitwise: {loaded} {'ok' if ok else 'FAIL'} [{smi}]")
        if not ok:
            raise RuntimeError("the training CLI on the card failed its checks")
        del state_a, trainer_a, state_b, probe
    torch.cuda.empty_cache()

    # (d) one bf16 train step at B=16, split; the same step on plain ops; a profile window
    unet = copy.deepcopy(task32.unet)
    task = PoseConditionalTask(unet, task32.vae, task32.config)
    state = train_state.TrainState(0, unet, task32.vae, optim.make_optimizer(unet.parameters(), warm_up_steps=0))
    ema = copy.deepcopy(unet).requires_grad_(False)
    step = train_state.make_train_step(task, half_precision=True, ema_decay=0.999)
    host = {"ds": train_pairs(torch, TRAIN_BATCH, 93)}
    batches = {"ds": {k: torch.from_numpy(v).to(dev) for k, v in host["ds"].items()}}
    t_step = median_ms(torch, lambda: step(state, batches, ema))
    with plain_ops():
        t_plain = median_ms(torch, lambda: step(state, batches, ema))
    half_vae = train_state._HalfCopy()(task32.vae)
    imgs = {k: train_state.device_batch(batches["ds"][k], dev).to(torch.bfloat16) for k in ("query", "reference")}
    with torch.no_grad():
        t_vae = median_ms(torch, lambda: [half_vae.encode_image(imgs[k]) for k in imgs])
        q_lat, r_lat = (half_vae.encode_image(imgs[k]) for k in ("query", "reference"))
    poses = torch.cat([batches["ds"]["relativeR"], batches["ds"]["relativeR_inv"]]).to(torch.bfloat16)
    ref, target = torch.cat([r_lat, q_lat]), torch.cat([q_lat, r_lat])

    def forward():
        params = {n: p.to(torch.bfloat16) for n, p in unet.named_parameters()}
        pred = torch.func.functional_call(unet, params, (ref.permute(0, 3, 1, 2), poses))
        return torch.mean(torch.abs(pred.permute(0, 2, 3, 1) - target)).float()

    with torch.enable_grad():
        t_fwd = median_ms(torch, forward)
        state.opt.zero_grad()
        t_fb = median_ms(torch, lambda: forward().backward())
        with timed_recomputes(torch) as spans:
            state.opt.zero_grad()
            forward().backward()
        rec = span_ms(torch, spans)
    t_opt = median_ms(torch, lambda: (state.opt.step(), optim.ema_update(list(ema.parameters()),
                                                                            list(unet.parameters()), 0.999)))
    wait = max(0.0, 1.0 - t_step / step_ms)
    print(f"phase 9 (d): one bf16 train step at B={TRAIN_BATCH} (U-Net batch {2 * TRAIN_BATCH}), EMA on, batch on the "
          f"card (CUDA events, median of 3 after a warm-up) [{smi}]:")
    print(f"    whole step {t_step:.2f} ms ({1000 / t_step:.3f} steps/s, {TRAIN_BATCH * 1000 / t_step:.2f} pairs/s); "
          f"on plain ops (cuDNN convs, plain linear attention) {t_plain:.2f} ms")
    print(f"    VAE encode (2 x {TRAIN_BATCH} images) {t_vae:.2f} ms; U-Net forward + loss {t_fwd:.2f} ms; backward "
          f"{t_fb - t_fwd:.2f} ms, of which the plain recomputes K3 {rec['K3']:.2f} ms (x{len(spans['K3'])}), K2 "
          f"{rec['K2']:.2f} ms (x{len(spans['K2'])}); optimizer + EMA {t_opt:.2f} ms")
    print(f"    the card waits on the host in the CLI's loop: 1 - {t_step:.2f} / {step_ms:.2f} ms = {100 * wait:.1f}% "
          f"of its steady step [{smi}]")
    with timed_recomputes(torch):
        prof = profile_window(torch, f"bf16 train step B={TRAIN_BATCH}", lambda: step(state, batches, ema), top=10,
                              ranges=("K3 plain recompute", "K2 plain recompute"))
    out["timings"] = {"step_ms": t_step, "plain_ms": t_plain, "profile": prof}
    del unet, ema, state, task
    torch.cuda.empty_cache()
    return out


# -- phase 10: the parallel paths --------------------------------------------------


def _fresh_state(torch, task32, lr=1e-4):
    """A train state over a copy of ``task32``'s U-Net (the shared start)
    and its frozen VAE, AdamW at ``lr`` from step 0."""
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask
    from nope_tpu_torch.training import optim, train_state

    unet = copy.deepcopy(task32.unet)
    task = PoseConditionalTask(unet, task32.vae, task32.config)
    return task, train_state.TrainState(0, unet, task32.vae, optim.make_optimizer(unet.parameters(), base_lr=lr,
                                                                                  warm_up_steps=0))


def _max_diff(a, b):
    return max(float((x.detach() - y.detach()).abs().max()) for x, y in zip(a.parameters(), b.parameters()))


def _delta_check(torch, dp, single, start):
    """Phase 9 (b)'s measures of two fp32 steps' weight deltas from
    ``start``: the max over the elements whose single-process gradient is
    >= 1e-4 of its tensor's largest, relative to max|Δ_single|; the
    relative L2 distance over all; the share of elements decided."""
    num, top, kept, total, sq_diff, sq_ref = 0.0, 0.0, 0, 0, 0.0, 0.0
    for p_dp, p_1, p_0 in zip(dp.parameters(), single.parameters(), start.parameters()):
        d_dp, d_1 = (p_dp.detach() - p_0.detach()), (p_1.detach() - p_0.detach())
        keep = p_1.grad.abs() >= 1e-4 * p_1.grad.abs().max()
        diff = (d_dp - d_1).abs()
        num = max(num, float(diff[keep].max()) if bool(keep.any()) else 0.0)
        top = max(top, float(d_1.abs().max()))
        kept, total = kept + int(keep.sum()), total + keep.numel()
        sq_diff, sq_ref = sq_diff + float((diff.double() ** 2).sum()), sq_ref + float((d_1.double() ** 2).sum())
    return num / top, (sq_diff / sq_ref) ** 0.5, kept / total


def _group_grad_rel(torch, got, want):
    """Worst rel (max|Δg| / max|g|) of ``got``'s gradients against
    ``want``'s over the grad-trace groups (phase 9 (a)'s measure)."""
    from nope_tpu_torch.training import train_state

    groups = train_state._grad_trace_groups(want)
    g_got, g_want = dict(got.named_parameters()), dict(want.named_parameters())
    rels = {}
    for grp in train_state.GRAD_TRACE_GROUPS:
        names = [n for n, g in groups.items() if g == grp]
        num = max(float((g_got[n].grad.float() - g_want[n].grad.float()).abs().max()) for n in names)
        rels[grp] = num / max(float(g_want[n].grad.float().abs().max()) for n in names)
    return rels


def _topk_check(torch, got_sim, got_idx, want_sim, want_idx, k=1, rtol=BF16_SIM_RTOL):
    """rel of the scores, and the top-k equal on every row whose k gaps
    between consecutive scores of its top k+1 all exceed ``rtol`` of the
    row's largest |score| (phase 6's bf16 measure at k = 1): (rel,
    decided rows, equal rows, ok)."""
    _, rel = rel_err(got_sim, want_sim)
    want_sim = want_sim.float()
    top = want_sim.topk(k + 1, dim=1).values
    decided = ((top[:, :-1] - top[:, 1:]) > rtol * want_sim.abs().amax(1, keepdim=True)).all(1).cpu()
    same = (got_idx[:, :k].cpu() == want_idx[:, :k].cpu()).all(1)
    return rel, int(decided.sum()), int(same.sum()), bool(same[decided].all())


def parallel_rank(rank, world, init_method, plan):
    """Phase 10 (b): one of 2 ranks in a gloo group on one card (NCCL
    refuses a card twice), started fresh by ``parallel.launch``.  Rank 0
    also runs each path in one process (no collective) and compares; it
    returns the numbers, every rank its kernels' launches per path."""
    global IMAGE, LATENT
    sys.path.insert(0, str(ROOT))
    import tempfile

    import torch

    from nope_tpu_torch.cli import train as train_cli
    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.data.builder import build_dataset
    from nope_tpu_torch.data.pipeline import DataLoader
    from nope_tpu_torch.evaluation.geodesic import evaluate_geodesic
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.ops import fused_resnet as fr
    from nope_tpu_torch.ops import linear_attention as la
    from nope_tpu_torch.ops import similarity as sim
    from nope_tpu_torch.parallel.eval import make_sharded_streaming_eval_fn
    from nope_tpu_torch.parallel.mesh import create_mesh, initialize_distributed, process_barrier, shard_batch
    from nope_tpu_torch.parallel.zero import zero1_state_shardings
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask
    from nope_tpu_torch.training import train_state

    IMAGE, LATENT = plan["image"], plan["image"] // 8
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # bitwise-repeatable cuDNN backward, so a difference is the path's
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dev = initialize_distributed("gloo", plan["device"], init_method, rank, world)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    counters = (sim.reference_similarity, la.linear_attention_inner, fr.resnet_block)
    cfg = load_config(None, plan["overrides"])
    task32 = build_task(cfg.model, dev, torch.Generator().manual_seed(0))
    out = {"launches": {}, "seconds": {}}

    def counted(name, fn):
        for c in counters:
            c.launches = 0
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = {c.__name__: c.launches for c in counters}
        return result

    # the data-parallel step: fp32 and bf16, ZeRO-1; global B = PAR_BATCH, half a rank
    mesh = create_mesh(2, 1)
    batches = {"ds": train_pairs(torch, PAR_BATCH, 95)}
    local = shard_batch(batches, mesh)

    def dp_step(half, zero=False):
        task, state = _fresh_state(torch, task32)
        shardings = zero1_state_shardings(state, mesh) if zero else None
        _, m = train_state.make_train_step(task, half_precision=half, state_shardings=shardings,
                                           mesh=mesh)(state, local)
        return state, float(m["loss/train_avg"])

    def single_step(half):
        task, state = _fresh_state(torch, task32)
        _, m = train_state.make_train_step(task, half_precision=half)(state, batches)
        return state, float(m["loss/train_avg"])

    dp32, loss_dp32 = counted("fp32 step", lambda: dp_step(False))
    if rank == 0:
        one, loss_one = single_step(False)
        step1, l2, kept = _delta_check(torch, dp32.unet, one.unet, task32.unet)
        out["fp32"] = {"loss": (loss_dp32, loss_one), "loss_rel": abs(loss_dp32 - loss_one) / abs(loss_one),
                       "step1": step1, "l2": l2, "kept": kept}
        del one
    rep, _ = dp_step(False)
    zero, loss_zero = counted("ZeRO-1 fp32 step", lambda: dp_step(False, zero=True))
    out["zero"] = {"max_diff": _max_diff(zero.unet, dp32.unet), "repeat_diff": _max_diff(rep.unet, dp32.unet),
                   "loss": (loss_zero, loss_dp32), "sharded": zero.opt.sharded}
    del rep, zero, dp32
    dp16, loss_dp16 = counted("bf16 step", lambda: dp_step(True))
    if rank == 0:
        one, loss_one = single_step(True)
        out["bf16"] = {"loss": (loss_dp16, loss_one), "loss_rel": abs(loss_dp16 - loss_one) / abs(loss_one),
                       "grad_rel": _group_grad_rel(torch, dp16.unet, one.unet)}
        del one
    del dp16
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the template-parallel streaming eval at N=26, bf16, against one process
    half = task32.half()
    hb = eval_batch(torch, plan["grid"], PAR_BATCH, 96)
    out["stream"] = {}
    for d, t in ((1, 2), (2, 1)):
        run = make_sharded_streaming_eval_fn(half, create_mesh(d, t), chunk_size=PAR_CHUNK)
        got = counted(f"streaming eval {d}x{t}", lambda: run(hb["reference"], hb["query"], hb["all_relativeR"]))
        if rank == 0:
            db = on_device(torch, hb, dev, torch.bfloat16)
            want = half.retrieve_streaming(db["query"], db["reference"], db["all_relativeR"], PAR_CHUNK)
            out["stream"][f"{d}x{t}"] = _topk_check(torch, *got, *want)
    del half

    # evaluate_geodesic, fp32, each rank its part of every batch of a PNG root, merged
    fp32 = PoseConditionalTask(task32.unet, task32.vae, dataclasses.replace(task32.config, half_precision_eval=False))
    ds_cfg = dataclasses.replace(load_config(None, [f"data.datasets.shapeNet.root_dir={plan['eval_root']}",
                                                    f"data.datasets.shapeNet.img_size={IMAGE}"]).data.datasets[
        "shapeNet"], split=CLI_CATEGORIES[0])

    def loader():
        return DataLoader(build_dataset(ds_cfg), batch_size=CLI_BATCH, shuffle=False, drop_last=False, num_workers=4)

    merged = counted("evaluate_geodesic merged", lambda: evaluate_geodesic(fp32, loader().shard(rank, world)))
    if rank == 0:
        out["eval"] = {"merged": merged, "one": evaluate_geodesic(fp32, loader(), sync_processes=False)}
    del fp32, task32
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # cli.train on both ranks: PAR_STEPS bf16 steps, a checkpoint at PAR_CKPT, then a resume from it
    shared = Path(plan["tmp"]) / "cli"
    common = ["--max-steps", str(PAR_STEPS), "--device", plan["device"], "--dist-backend", "gloo",
              *plan["overrides"], f"data.datasets.shapeNet.root_dir={plan['train_root']}",
              f"data.datasets.shapeNet.img_size={IMAGE}", "model.optim_config.half_precision_train=true",
              f"machine.batch_size={PAR_BATCH}", f"trainer.val_check_interval={PAR_STEPS}",
              "trainer.media_every_n_steps=0", "trainer.num_sanity_val_steps=0", "trainer.log_every_n_steps=1",
              "name_exp=train"]
    counted("cli.train", lambda: train_cli.main([*common, f"trainer.checkpoint_every_n_steps={PAR_CKPT}",
                                                 f"save_dir={shared / 'a'}"]))
    name = f"ckpt_{PAR_CKPT:08d}.pt"
    if rank == 0:
        (shared / "b" / "train" / "checkpoints").mkdir(parents=True)
        os.link(shared / "a" / "train" / "checkpoints" / name, shared / "b" / "train" / "checkpoints" / name)
    process_barrier("resume_ready")
    # the resumed run saves no checkpoint of its own
    counted("cli.train resumed", lambda: train_cli.main([*common, f"trainer.checkpoint_every_n_steps={10 * PAR_STEPS}",
                                                         f"save_dir={shared / 'b'}"]))
    if rank == 0:
        read = lambda d: [json.loads(x) for x in open(shared / d / "train" / "metrics.jsonl")]  # noqa: E731
        rec_a, rec_b = read("a"), read("b")
        out["cli"] = {
            "loss_a": {r["step"]: r["loss/train_avg"] for r in rec_a if "loss/train_avg" in r},
            "loss_b": {r["step"]: r["loss/train_avg"] for r in rec_b if "loss/train_avg" in r},
            "val_images": [v for r in rec_a for k, v in r.items() if k.endswith("num_images")],
            "checkpoints": sorted(n for n in os.listdir(shared / "a" / "train" / "checkpoints") if n.startswith("ckpt_")),
        }
    return out


def parallel_phase(torch, dev, smi, counters, task32, half, grids, phase9_step_ms, backend="nccl",
                   rank_device="cuda:0", overrides=()):
    """Phase 10: the parallel paths at full width.  (a) one rank of an
    NCCL group in this process; (b) two fresh ranks on this card in a
    gloo group (``parallel_rank``).  Returns each kernel's launches in
    (a) and in (b) (both ranks, every path)."""
    import tempfile

    import torch.distributed as dist

    from nope_tpu_torch.parallel.eval import make_sharded_streaming_eval_fn
    from nope_tpu_torch.parallel.launch import run_ranks
    from nope_tpu_torch.parallel.mesh import create_mesh, initialize_distributed
    from nope_tpu_torch.training import train_state

    print(f"phase 10: the parallel paths (full width, seeded random weights; cuDNN deterministic) [{smi}]")
    names = [fn.__name__ for fn in counters]
    out = {"a": dict.fromkeys(names, 0), "b": dict.fromkeys(names, 0)}
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def launches():
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches for fn in counters}
        for k, v in got.items():
            out["a"][k] += v
        return got

    # (a) one rank, NCCL: the data-parallel bf16 step and the streaming eval against one process
    with tempfile.TemporaryDirectory(prefix="nope_store_") as store:
        initialize_distributed(backend, dev, f"file://{store}/store", 0, 1)
        try:
            mesh = create_mesh(1, 1)
            batches = {"ds": train_pairs(torch, PAR_BATCH, 94)}

            def bf16(m):
                task, state = _fresh_state(torch, task32)
                step = train_state.make_train_step(task, half_precision=True, mesh=m)
                _, metrics = step(state, batches)
                return state, float(metrics["loss/train_avg"]), step

            one, loss_one, step_one = bf16(None)
            again, loss_again, _ = bf16(None)
            for fn in counters:
                fn.launches = 0
            dp, loss_dp, step_dp = bf16(mesh)
            got = launches()
            d_dp, d_rep = _max_diff(dp.unet, one.unet), _max_diff(again.unet, one.unet)
            # the train step runs K3 and K2 (K1 scores retrieval only)
            ok = (d_dp <= d_rep and abs(loss_dp - loss_one) <= abs(loss_again - loss_one)
                  and got["resnet_block"] and got["linear_attention_inner"])
            print(f"  (a) 1 rank, {backend}, mesh (1, 1): bf16 data-parallel step at B={PAR_BATCH} (all-reduce SUM / 1) "
                  f"vs the single-process step, same batch and masters: loss {loss_dp:.7f} vs {loss_one:.7f}, weights "
                  f"max|Δ| {d_dp:.3e} (the single step against itself: {d_rep:.3e}, loss {abs(loss_again - loss_one):.3e}); "
                  f"launches {got} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("the one-rank data-parallel step differs from the single-process step")
            del again
            # the two steps in turn (single, DP, DP, single, ...), so drift on the host hits both
            times = {"one": [], "dp": []}
            for order in (("one", "dp"), ("dp", "one")) * (PAR_ROUNDS // 2):
                for name in order:
                    st, fn = (one, step_one) if name == "one" else (dp, step_dp)
                    times[name].append(median_ms(torch, lambda: fn(st, batches), reps=1, warmup=0))
            t_one, t_dp = (float(np.median(times[k])) for k in ("one", "dp"))
            print(f"  (a) bf16 step at B={PAR_BATCH}, batch on the host (CUDA events, {PAR_ROUNDS} of each in turn, "
                  f"medians; spread {min(times['one']):.2f}-{max(times['one']):.2f} and "
                  f"{min(times['dp']):.2f}-{max(times['dp']):.2f} ms): single-process {t_one:.2f} ms, data-parallel "
                  f"over 1 {backend} rank {t_dp:.2f} ms ({t_dp - t_one:+.2f} ms, the parallel path's own cost on one "
                  f"card); phase 9 (d)'s step with EMA {phase9_step_ms:.2f} ms [{smi}]")
            out["timings"] = {"single_ms": t_one, "dp_ms": t_dp}
            del one, dp
            torch.cuda.empty_cache()
            hb = eval_batch(torch, grids[FULL_N], PAR_BATCH, 97)
            run = make_sharded_streaming_eval_fn(half, mesh, chunk_size=31)
            for fn in counters:
                fn.launches = 0
            sim_p, idx_p = run(hb["reference"], hb["query"], hb["all_relativeR"])
            got = launches()
            db = on_device(torch, hb, dev, torch.bfloat16)
            sim_w, idx_w = half.retrieve_streaming(db["query"], db["reference"], db["all_relativeR"], 31)
            err, rel = rel_err(sim_p, sim_w)
            same = torch.equal(idx_p, idx_w)
            ok = rel <= BF16_SIM_RTOL and same and all(got.values())
            print(f"  (a) make_sharded_streaming_eval_fn, mesh (1, 1), bf16 B={PAR_BATCH} N={FULL_N} chunk_size 31 vs "
                  f"retrieve_streaming: max_abs {err:.3e} rel {rel:.3e} (tol {BF16_SIM_RTOL:.0e}), top-k "
                  f"{'equal' if same else 'DIFFER'}; launches {got} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("the one-rank streaming eval differs from retrieve_streaming")
            del sim_p, sim_w, db
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) two ranks on this one card, gloo (a correctness check, not a scaling number)
    with tempfile.TemporaryDirectory(prefix="nope_par_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_shapenet_root(tmp / "eval", categories=CLI_CATEGORIES[:1])
        write_training_root(tmp / "train")
        t_roots = time.perf_counter() - t0
        plan = {"device": rank_device, "image": IMAGE, "overrides": list(overrides), "grid": grids[FAST_N],
                "eval_root": str(tmp / "eval"), "train_root": str(tmp / "train"), "tmp": str(tmp)}
        t0 = time.perf_counter()
        ranks = run_ranks(parallel_rank, 2, (plan,), timeout=PAR_TIMEOUT)
        wall = time.perf_counter() - t0
    for r in ranks:
        for path in r["launches"].values():
            for k, v in path.items():
                out["b"][k] += v
    r0 = ranks[0]
    print(f"  (b) 2 ranks on {rank_device}, gloo, started fresh: {wall:.1f} s of wall (roots written in {t_roots:.1f} s "
          f"before); per path, rank 0's seconds and both ranks' launches (two ranks sharing one card: a correctness "
          f"check, not a scaling number):")
    for path, secs in r0["seconds"].items():
        per_rank = [r["launches"].get(path) for r in ranks]
        print(f"    {path:<28} {secs:7.2f} s  launches rank 0 {per_rank[0]}, rank 1 {per_rank[1]}")
    f = r0["fp32"]
    ok = (f["loss_rel"] <= TRAIN_LOSS_RTOL and f["step1"] <= TRAIN_DELTA_RTOL and f["l2"] <= TRAIN_DELTA_RTOL
          and f["kept"] >= 0.99)
    print(f"  (b) fp32 data-parallel step, 2 x {PAR_BATCH // 2} pairs vs one process's {PAR_BATCH}: loss "
          f"{f['loss'][0]:.7f} vs {f['loss'][1]:.7f} rel {f['loss_rel']:.2e} (tol {TRAIN_LOSS_RTOL:.0e}); weight deltas "
          f"max over the {100 * f['kept']:.3f}% decided elements {f['step1']:.2e}, relative L2 {f['l2']:.2e} (tol "
          f"{TRAIN_DELTA_RTOL:.0e}) {'ok' if ok else 'FAIL'}")
    checks = [("fp32 step", ok)]
    h = r0["bf16"]
    worst = max(h["grad_rel"].values())
    ok = h["loss_rel"] <= GRAD_TOL["bfloat16"] and worst <= GRAD_TOL["bfloat16"]
    print(f"  (b) bf16 data-parallel step vs one process: loss rel {h['loss_rel']:.2e}, averaged gradients worst rel by "
          f"group " + ", ".join(f"{g} {v:.2e}" for g, v in h["grad_rel"].items())
          + f" (tol {GRAD_TOL['bfloat16']:.0e}) {'ok' if ok else 'FAIL'}")
    checks.append(("bf16 step", ok))
    for r in ranks:
        z = r["zero"]
        ok = z["sharded"] and z["max_diff"] <= z["repeat_diff"] and z["loss"][0] == z["loss"][1]
        checks.append(("ZeRO-1", ok))
    z = r0["zero"]
    print(f"  (b) ZeRO-1 fp32 step vs the replicated step, from the same start: weights max|Δ| {z['max_diff']:.3e} "
          f"(the replicated step against itself {z['repeat_diff']:.3e}), loss {z['loss'][0]:.7f} vs {z['loss'][1]:.7f} "
          f"{'ok' if checks[-1][1] and checks[-2][1] else 'FAIL'}")
    for mesh_name, (rel, decided, same, top1) in r0["stream"].items():
        ok = rel <= BF16_SIM_RTOL and top1
        checks.append((f"streaming {mesh_name}", ok))
        print(f"  (b) make_sharded_streaming_eval_fn, mesh ({mesh_name.replace('x', ', ')}), bf16 B={PAR_BATCH} "
              f"N={FAST_N} chunk_size {PAR_CHUNK} vs one process: rel {rel:.3e} (tol {BF16_SIM_RTOL:.0e}); top-1 margin "
              f"above {BF16_SIM_RTOL:.0e} of |score| in {decided} of {PAR_BATCH} rows, top-1 equal in {same} "
              f"{'ok' if ok else 'FAIL'}")
    got, want = r0["eval"]["merged"], r0["eval"]["one"]
    ok = set(got) == set(want) and got["num_images"] == want["num_images"] > 0
    for key, value in want.items():
        if "accuracy" in key:
            ok &= got[key] == value
        elif "median" in key:
            ok &= abs(got[key] - value) <= 1e-3
        elif key == "loss":
            ok &= abs(got[key] - value) <= 1e-5 * abs(value)
    checks.append(("merged eval", ok))
    print(f"  (b) evaluate_geodesic fp32 over a PNG root ({CLI_CATEGORIES[0]}, {int(want['num_images'])} queries, "
          f"batches of {CLI_BATCH}), each rank its part, merged, vs one process: top1 acc15 {got['top1, accuracy_15']:.2f}"
          f" vs {want['top1, accuracy_15']:.2f}, top1 median {got['top1, median']:.4f} vs {want['top1, median']:.4f}, "
          f"loss {got['loss']:.7f} vs {want['loss']:.7f}, images {got['num_images']:.0f} {'ok' if ok else 'FAIL'}")
    c = r0["cli"]
    resumed = sorted(c["loss_b"]) == list(range(PAR_CKPT + 1, PAR_STEPS + 1))
    worst = max(abs(c["loss_b"][s] - c["loss_a"][s]) / abs(c["loss_a"][s]) for s in c["loss_b"]) if resumed else 1.0
    ok = (sorted(c["loss_a"]) == list(range(1, PAR_STEPS + 1)) and all(np.isfinite(list(c["loss_a"].values())))
          and resumed and worst <= RESUME_LOSS_RTOL and c["checkpoints"] == [f"ckpt_{PAR_CKPT:08d}.pt"]
          and c["val_images"])
    checks.append(("cli.train", ok))
    print(f"  (b) cli.train.main on 2 ranks, bf16, B={PAR_BATCH} ({PAR_BATCH // 2} a rank): {PAR_STEPS} steps, losses "
          f"{[round(c['loss_a'][s], 6) for s in sorted(c['loss_a'])]}, rank 0's checkpoints {c['checkpoints']}, merged "
          f"validation of {c['val_images']} images; a second main resumed from step {PAR_CKPT}: losses worst rel "
          f"{worst:.3e} (tol {RESUME_LOSS_RTOL:.0e}) {'ok' if ok else 'FAIL'}")
    print(f"  launches over (a): {out['a']}; over (b), both ranks: {out['b']}")
    failed = [name for name, good in checks if not good]
    if failed or not all(out["b"].values()):
        raise RuntimeError(f"phase 10 (b) failed: {failed or out['b']}")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    return out


# -- phase 11: the model zoo ------------------------------------------------------------


def zoo_configs():
    """The three configurations of phase 11, full width, 256-px images:
    the repo's LDM preset, the ADM variant at ``UNetConfig``'s ``gd_*``
    defaults, and ``template_base`` with the ResNet-50 template encoder
    (descriptor 8)."""
    from nope_tpu_torch.configs import load_config

    return {
        "vae_cin_ldm": load_config(str(ROOT / "configs" / "model_ldm.yaml")).model,
        "vae_guidedDiffusion": load_config(None, ["model.u_net.variant=vae_guidedDiffusion"]).model,
        "template_base": load_config(None, ["model.u_net.variant=template_base", "model.encoder.kind=template",
                                            "model.encoder.latent_dim=8", "model.encoder.descriptor_size=8"]).model,
    }


def noise_zero_layers(torch, module, seed):
    """Seeded LeCun-normal noise over the layers the factory leaves at zero
    (as JAX does): with them at zero every template's prediction is the
    same and retrieval ties."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if getattr(m, "zero_init", False):
                w = torch.randn(m.weight.shape, generator=gen) / float(np.sqrt(m.weight[0].numel()))
                m.weight.copy_(w.to(m.weight.device))
                m.bias.copy_((0.1 * torch.randn(m.bias.shape, generator=gen)).to(m.bias.device))
    return module


def zoo_infer_cli(torch, task32, est26, rng):
    """Phase 11 (c): ``cli.infer.main --config configs/model_ldm.yaml --fast``
    over two PNGs written here, with a checkpoint the port saved of the
    seeded task; its answer against the in-process estimator's."""
    import tempfile

    from nope_tpu_torch.cli import infer
    from nope_tpu_torch.data.png import write_png
    from nope_tpu_torch.training.checkpoint import save_reference_checkpoint

    ref8, q8 = (rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8) for _ in range(2))
    with tempfile.TemporaryDirectory(prefix="nope_zoo_") as tmp:
        paths = {k: os.path.join(tmp, f"{k}.png") for k in ("reference", "query")}
        write_png(paths["reference"], ref8)
        write_png(paths["query"], q8)
        ckpt, out = os.path.join(tmp, "ldm.pth"), os.path.join(tmp, "poses.json")
        t0 = time.perf_counter()
        save_reference_checkpoint(ckpt, task32.unet.state_dict(), task32.vae.state_dict())
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        infer.main(["--config", str(ROOT / "configs" / "model_ldm.yaml"), "--fast", "--reference", paths["reference"],
                    "--queries", paths["query"], "--checkpoint", ckpt, "--out", out])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        with open(out) as f:
            payload = json.load(f)
    # the CLI's image reader: uint8 → float32 in [-1, 1] on the host
    est26.register_object("cli", (ref8.astype(np.float32) / 255.0) * 2.0 - 1.0)
    want = est26.estimate("cli", ((q8.astype(np.float32) / 255.0) * 2.0 - 1.0)[None])
    entry = payload["results"][0]
    sim = np.asarray(entry["similarity"], np.float32)
    err = float(np.abs(sim - want.similarity[0]).max() / np.abs(want.similarity[0]).max())
    ok = (payload["num_templates"] == FAST_N and len(payload["results"]) == 1 and np.isfinite(sim).all()
          and entry["topk_template_idx"] == want.nearest_idx[0].tolist() and err <= BF16_SIM_RTOL)
    print(f"  (c) cli.infer.main --config configs/model_ldm.yaml --fast, 2 PNGs, the port's checkpoint (saved in "
          f"{t_save:.2f} s): {t_cli:.1f} s; top-5 {entry['topk_template_idx']} vs the in-process estimator's "
          f"{want.nearest_idx[0].tolist()}, similarity rel {err:.2e} (tol {BF16_SIM_RTOL:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("cli.infer.main with the LDM preset disagrees with the estimator")


def zoo_train_step(torch, smi, task32):
    """Phase 11 (d): one bf16 train step of the LDM variant at B=16 with
    ``grad_trace``: its groups for a U-Net that is not a PoseUNet."""
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask
    from nope_tpu_torch.training import optim, train_state

    unet = copy.deepcopy(task32.unet)
    task = PoseConditionalTask(unet, task32.vae, task32.config)
    state = train_state.TrainState(0, unet, task32.vae, optim.make_optimizer(unet.parameters(), warm_up_steps=0))
    step = train_state.make_train_step(task, half_precision=True, grad_trace=True)
    pairs = train_pairs(torch, ZOO_TRAIN_BATCH, 111)
    batches = {"ds": {k: torch.from_numpy(v).to(task32.device) for k, v in pairs.items()}}
    torch.cuda.reset_peak_memory_stats()
    t_step = median_ms(torch, lambda: step(state, batches))
    m = train_state.to_numpy_metrics(step(state, batches)[1])
    peak = torch.cuda.max_memory_allocated() / 2**30
    groups = {g: m[f"gnorm/{g}"] for g in train_state.GRAD_TRACE_GROUPS}
    ok = (np.isfinite(list(m.values())).all() and groups["cond_mlp"] == 0.0
          and all(groups[g] > 0 for g in ("pose_mlp", "attn", "conv")) and state.step == 5)
    print(f"  (d) vae_cin_ldm one bf16 train step at B={ZOO_TRAIN_BATCH} (U-Net batch {2 * ZOO_TRAIN_BATCH}), "
          f"grad_trace: "
          f"{t_step:.2f} ms, peak {peak:.2f} GiB; loss {m['loss/train_avg']:.5f}; gnorm "
          + ", ".join(f"{g} {v:.4e}" for g, v in groups.items()) + f" {'ok' if ok else 'FAIL'} [{smi}]")
    if not ok:
        raise RuntimeError("the LDM train step's grad-trace groups are wrong")
    del unet, state, task
    return t_step


@contextlib.contextmanager
def k1_held(worst):
    """Inside the block every retrieval score (the "l2" metric, K1) is also
    computed by K1's plain version on the same inputs; ``worst`` gets the
    largest relative difference per (query shape, bank's leading dims,
    dtype)."""
    from nope_tpu_torch.ops import similarity as sim

    kernel = sim._METRICS["l2"]

    def held(query, bank):
        got = kernel(query, bank)
        _, rel = rel_err(got, sim.reference_similarity_plain(query.float(), bank.float()))
        key = (tuple(query.shape), tuple(bank.shape[:2]), str(query.dtype).split(".")[-1])
        worst[key] = max(worst.get(key, 0.0), rel)
        return got

    sim._METRICS["l2"] = held
    try:
        yield
    finally:
        sim._METRICS["l2"] = kernel


@contextlib.contextmanager
def plain_k1():
    """Retrieval scored by K1's plain version (no kernel)."""
    from nope_tpu_torch.ops import similarity as sim

    kernel = sim._METRICS["l2"]
    sim._METRICS["l2"] = sim.reference_similarity_plain
    try:
        yield
    finally:
        sim._METRICS["l2"] = kernel


def zoo_plain_check(torch, name, task32, half, batch, chunk, est26, q64, res):
    """Phase 11 (b), after its launches are read: K1 at this configuration's
    own shapes (estimate and the eval step) against its plain version on the
    same inputs, at phase 2's K1 limit; and the whole bf16 eval step against
    the same step with all three ops on their plain versions (K2 and K3 in
    template_base), similarity within BF16_SIM_RTOL and the top-1 equal on
    every decided row."""
    worst = {}
    with k1_held(worst):
        if est26 is not None:
            est26.estimate("o", q64)
        task32.eval_geodesic_step(batch, chunk_size=chunk, infer_task=half)
    with plain_ops(), plain_k1():
        plain = task32.eval_geodesic_step(batch, chunk_size=chunk, infer_task=half)
    k1_rel = max(worst.values())
    rel, decided, same, top1 = _topk_check(torch, res["similarity"], res["nearest_idx"], plain["similarity"],
                                           plain["nearest_idx"])
    ok = k1_rel <= TOL["bfloat16"]["K1"] and rel <= BF16_SIM_RTOL and top1
    shapes = ", ".join(f"q {q} bank {t} rel {r:.2e}" for (q, t, _), r in worst.items())
    print(f"    (b) K1 held on its own inputs, bf16: {shapes} (tol {TOL['bfloat16']['K1']:.0e}); eval step vs all "
          f"ops plain: similarity rel {rel:.3e} (tol {BF16_SIM_RTOL:.0e}), top-1 margin above {BF16_SIM_RTOL:.0e} of "
          f"|score| in {decided} of {len(plain['nearest_idx'])} rows, top-1 equal in {same} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: the kernels disagree with their plain versions at phase 11's shapes")


def model_zoo_phase(torch, dev, smi, counters):
    """Phase 11: the LDM preset, the ADM variant and ``template_base`` at
    full width with seeded weights (the factory's zero layers overwritten
    by noise).  Returns each configuration's kernel launches over (b)."""
    from nope_tpu_torch.geometry import so3_grid
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.serving import PoseEstimator

    print(f"phase 11: the model zoo (full width, 256-px images, seeded weights; CUDA events, medians of 3) [{smi}]")
    rng = np.random.default_rng(11)
    ref = rng.uniform(-1, 1, (IMAGE, IMAGE, 3)).astype(np.float32)
    q64 = rng.integers(0, 256, (64, IMAGE, IMAGE, 3), dtype=np.uint8)
    indexes = so3_grid.load_index_level0_in_level2("upper")
    grid = so3_grid.get_obj_poses_from_template_level(2, "all")[indexes][:, :3, :3].astype(np.float32)
    out = {}
    for i, (name, cfg) in enumerate(zoo_configs().items()):
        t0 = time.perf_counter()
        task32 = build_task(cfg, dev, torch.Generator().manual_seed(110 + i))
        noise_zero_layers(torch, task32.unet, 120 + i)
        params = sum(p.numel() for p in task32.unet.parameters()) / 1e6
        enc_params = sum(p.numel() for p in task32.vae.parameters()) / 1e6
        print(f"  {name}: {type(task32.unet).__name__} {params:.1f} M parameters, {type(task32.vae).__name__} "
              f"{enc_params:.1f} M, latent {LATENT}x{LATENT}x{cfg.encoder.latent_dim}; built in "
              f"{time.perf_counter() - t0:.1f} s")

        # (a) float32 on the card against the CPU, 2 items
        t0 = time.perf_counter()
        unet_cpu, enc_cpu = copy.deepcopy(task32.unet).cpu(), copy.deepcopy(task32.vae).cpu()
        imgs = torch.from_numpy(rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32))
        pose = torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32))
        with torch.no_grad():
            lat_cpu = enc_cpu.encode_image(imgs)
            pred_cpu = unet_cpu(lat_cpu.permute(0, 3, 1, 2), pose)
            lat = task32.encode(imgs.to(dev))
            pred = task32.unet(lat_cpu.permute(0, 3, 1, 2).to(dev), pose.to(dev))
        (_, enc_rel), (_, unet_rel) = rel_err(lat.cpu(), lat_cpu), rel_err(pred.cpu(), pred_cpu)
        ok = enc_rel <= CPU_SIM_RTOL and unet_rel <= CPU_SIM_RTOL and torch.isfinite(pred).all().item()
        print(f"    (a) fp32 card vs CPU, 2 items, TF32 off: encoder rel {enc_rel:.2e}, U-Net rel {unet_rel:.2e} "
              f"(tol {CPU_SIM_RTOL:.0e}); {time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{name}: the fp32 card path disagrees with the CPU path")
        del unet_cpu, enc_cpu, pred_cpu, lat_cpu

        # (b) bf16 serving and the eval step, every kernel counted over them
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        est26 = None
        if cfg.encoder.kind == "vae":
            est341 = PoseEstimator(task32, fast_evaluation=False)
            t_reg = median_ms(torch, lambda: est341.register_object("o", ref), reps=3, warmup=1)
            del est341
            est26 = PoseEstimator(task32, fast_evaluation=True)
            est26.register_object("o", ref)
            t_est = median_ms(torch, lambda: est26.estimate("o", q64), reps=3, warmup=1)
            r = est26.estimate("o", q64)
            ok = r.nearest_idx.shape == (64, 5) and np.isfinite(r.similarity).all()
            print(f"    (b) register_object bf16 N={FULL_N} {t_reg:.2f} ms; estimate bf16 N={FAST_N} B=64 {t_est:.2f} "
                  f"ms ({64000 / t_est:.1f} queries/s); top-1 spread over {len(np.unique(r.nearest_idx[:, 0]))} "
                  f"templates {'ok' if ok else 'FAIL'} [{smi}]")
            if not ok:
                raise RuntimeError(f"{name}: bad estimate")
        else:
            try:
                PoseEstimator(task32, fast_evaluation=True).register_object("o", ref)
            except AttributeError as e:  # as the JAX package's engine (tests/test_torch_template_encoder.py)
                print(f"    (b) not served, as in the JAX package: PoseEstimator pins a VAE's latent geometry ({e})")
            else:
                raise RuntimeError("template_base registered: the serving gap the JAX package has is gone")
        b, chunk = ZOO_EVAL[name]
        batch = on_device(torch, eval_batch(torch, grid, b, 112 + i), dev)
        half = task32.half()
        t_eval = median_ms(torch, lambda: task32.eval_geodesic_step(batch, chunk_size=chunk, infer_task=half))
        res = task32.eval_geodesic_step(batch, chunk_size=chunk, infer_task=half)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = out[name] = {fn.__name__: fn.launches for fn in counters}
        sim_ = res["similarity"]
        ok = (sim_.shape == (b, FAST_N) and torch.isfinite(sim_).all().item() and torch.isfinite(res["loss"]).item()
              and int(res["nearest_idx"].max()) < FAST_N and launches["reference_similarity"] > 0
              and all((launches[k] > 0) == (name == "template_base")
                      for k in ("linear_attention_inner", "resnet_block")))
        print(f"    (b) eval_geodesic_step B={b} N={FAST_N} chunk_size {chunk} (bf16 retrieval, fp32 loss): "
              f"{t_eval:.2f} ms "
              f"({1000 * b / t_eval:.2f} img/s); peak over (b) {peak:.2f} GiB; mean top-1 error "
              f"{float(res['error_deg'].mean()):.1f} deg; launches over (b) {launches} {'ok' if ok else 'FAIL'} "
              f"[{smi}]")
        if not ok:
            raise RuntimeError(f"{name}: the eval step failed its checks or a kernel count is off")
        zoo_plain_check(torch, name, task32, half, batch, chunk, est26, q64, res)
        del half, batch, res

        if name == "vae_cin_ldm":
            zoo_infer_cli(torch, task32, est26, rng)
            zoo_train_step(torch, smi, task32)
        del est26, task32
        torch.cuda.empty_cache()
    return out


# -- phase 12: the BOP / T-LESS path -----------------------------------------------------


VSD_KEYS = {f"top {k}, {m}" for k in (1, 3, 5) for m in ("vsd_median", "vsd_scores 0.3")}


@contextlib.contextmanager
def bop_clocks(torch, record):
    """Inside the block each (bank, retrieval) pair of the task is timed on
    the card (CUDA events from the bank's call to the retrieval's return)
    and its similarity and top-k kept; ``evaluation.vsd.evaluate_vsd_batch``
    is timed on the host clock."""
    from nope_tpu_torch.evaluation import vsd
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask

    real = PoseConditionalTask.generate_template_bank, PoseConditionalTask.retrieval, vsd.evaluate_vsd_batch

    def bank(self, *args, **kwargs):
        record["start"] = torch.cuda.Event(enable_timing=True)
        record["start"].record()
        return real[0](self, *args, **kwargs)

    def retrieval(self, *args, **kwargs):
        sim, idx = real[1](self, *args, **kwargs)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        record["card_ms"].append(record.pop("start").elapsed_time(end))
        record["sim"].append(sim.cpu())
        record["idx"].append(idx.cpu())
        return sim, idx

    def evaluate(*args, **kwargs):
        t0 = time.perf_counter()
        errors = real[2](*args, **kwargs)
        record["vsd_ms"].append(1e3 * (time.perf_counter() - t0))
        return errors

    PoseConditionalTask.generate_template_bank, PoseConditionalTask.retrieval = bank, retrieval
    vsd.evaluate_vsd_batch = evaluate
    try:
        yield
    finally:
        PoseConditionalTask.generate_template_bank, PoseConditionalTask.retrieval, vsd.evaluate_vsd_batch = real


def bop_kernel_times(torch, smi, dev, k3_calls, k2_calls, check):
    """Phase 12: K3's and K2's float32 routes at this path's U-Net batches
    (a chunk of 31 templates and the whole bank of 341, 4 queries), each
    output held by phase 2's ``check`` against its plain version on the
    same inputs, then timed with the host in the loop and on the device
    alone, beside the plain versions, K3's ``F.conv2d`` and the bounds."""
    import torch.nn.functional as F

    from nope_tpu_torch.ops import fused_resnet as fr
    from nope_tpu_torch.ops import linear_attention as la

    gen = torch.Generator(device=dev).manual_seed(12)
    out = {"K3": {}, "K2": {}}
    for items in (BOP_BATCH * BOP_CHUNK, BOP_BATCH * FULL_N):
        reps = 3 if items < 1000 else 1
        tot_k = tot_d = tot_p = tot_l = 0.0
        work = [0.0, 0.0, 0.0]
        for shape in sorted(set(k3_calls), key=k3_calls.index):
            count = k3_calls.count(shape)
            x, emb, params = k3_inputs(torch, shape, items, dev, torch.float32, gen)
            check("K3", f"B={items} {shape[0]}x{shape[1]} {shape[2]}->{shape[3]} res={int(shape[4])} "
                  f"emb={int(shape[5])}", fr.resnet_block(x, emb, params, shape[6]),
                  fr.resnet_block_plain(x, emb, params, shape[6]), "float32")
            t_k = cuda_ms(torch, lambda: fr.resnet_block(x, emb, params, shape[6]), reps)
            t_d = device_ms(torch, lambda: fr.resnet_block(x, emb, params, shape[6]), reps)
            t_p = cuda_ms(torch, lambda: fr.resnet_block_plain(x, emb, params, shape[6]), reps)
            t_l = cuda_ms(torch, k3_library(torch, F, x, params), reps)
            tot_k, tot_d = tot_k + count * t_k, tot_d + count * t_d
            tot_p, tot_l = tot_p + count * t_p, tot_l + count * t_l
            work = [a + count * b for a, b in zip(work, k3_work(shape, items))]
            del x, emb, params
        b3 = bound(f32_ops=work[0] + work[1], nbytes=2 * work[2])
        out["K3"][items] = {"ms": tot_k, "device_ms": tot_d, "plain_ms": tot_p, "library_ms": tot_l,
                            "bound_ms": b3[0], "bound_by": b3[1]}
        print(f"  K3 fp32 (conv_nhwc) all 22 blocks of one U-Net forward at {items} items: kernel {tot_k:.3f} ms "
              f"(device alone {tot_d:.3f}) plain {tot_p:.3f} ms conv2d {tot_l:.3f} ms; bound {b3[0]:.3f} ms "
              f"({b3[1]}), kernel at {100 * b3[0] / tot_d:.1f}% of it (device alone) [{smi}]")
        fwd = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        for n in sorted({c[0] for c in k2_calls}, reverse=True):
            count = sum(1 for c in k2_calls if c[0] == n)
            qkv = 2 * torch.randn(items, n, 384, generator=gen, device=dev)
            check("K2", f"items={items} n={n}", la.linear_attention_inner(qkv, 4, 32),
                  la.linear_attention_inner_plain(qkv, 4, 32), "float32")
            t_k = cuda_ms(torch, lambda: la.linear_attention_inner(qkv, 4, 32), 5 * reps)
            t_d = device_ms(torch, lambda: la.linear_attention_inner(qkv, 4, 32), 5 * reps)
            t_p = cuda_ms(torch, lambda: la.linear_attention_inner_plain(qkv, 4, 32), reps)
            b2 = bound(f32_ops=float(items * n * 4) * (4 * 32 * 32 + 8 * 32),
                       nbytes=float(qkv.numel() + items * n * 128) * qkv.element_size())
            for key, v in zip(("ms", "device_ms", "plain_ms", "bound_ms"), (t_k, t_d, t_p, b2[0])):
                fwd[key] += count * v
            del qkv
        out["K2"][items] = fwd
        print(f"  K2 fp32 the {len(k2_calls)} launches of one U-Net forward at {items} items: kernel {fwd['ms']:.4f} ms "
              f"(device alone {fwd['device_ms']:.4f}) plain {fwd['plain_ms']:.4f} ms bound {fwd['bound_ms']:.4f} ms "
              f"(bytes), {100 * fwd['bound_ms'] / fwd['device_ms']:.1f}% of it (device alone) [{smi}]")
        torch.cuda.empty_cache()
    return out


def bop_phase(torch, dev, smi, counters, k3_calls, k2_calls, check, overrides=(), device_flag="cuda"):
    """Phase 12: the BOP / T-LESS VSD path.  (a) a procedural T-LESS root
    and the GT-pose VSD of every instance; (b) ``cli.export`` of seeded
    reference-format weights; (c) ``cli.test_bop.main`` in fp32, the bank
    streamed and whole, timed; (d) one batch's retrieval against the plain
    ops and against the CPU; (e) one fp32 train step each from the
    Objaverse and ``bop_texture`` loaders.  ``check`` is phase 2's hold of
    a kernel against its plain version; ``overrides`` are model overrides
    for every config (none at full width)."""
    import tempfile

    from nope_tpu_torch.cli import export, test_bop
    from nope_tpu_torch.configs import load_config
    from nope_tpu_torch.data import builder
    from nope_tpu_torch.data.bop import BOPDataset
    from nope_tpu_torch.data.pipeline import collate
    from nope_tpu_torch.evaluation import vsd
    from nope_tpu_torch.models.factory import build_task
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask
    from nope_tpu_torch.training import optim, train_state
    from nope_tpu_torch.training.checkpoint import restore_params

    print(f"phase 12: the BOP / T-LESS VSD path (full width, float32, seeded weights; {BOP_BATCH} queries a batch, "
          f"{FULL_N} templates each) [{smi}]")
    t_phase = time.perf_counter()
    overrides = list(overrides)
    out = {}
    with tempfile.TemporaryDirectory(prefix="nope_bop_") as tmp:
        # (a) the root, and VSD of every GT pose against its own scene depth
        t0 = time.perf_counter()
        root = os.path.join(tmp, "tless")
        n = write_bop_root(root)
        t_write = time.perf_counter() - t0
        ds = BOPDataset(root, None, "test_primesense", reset_metaData=True)
        t0 = time.perf_counter()
        gt_vsd = []
        for row in ds.metaData.rows():
            pose = np.asarray(row["pose"], np.float64).reshape(4, 4)
            frame = vsd.VSDFrame(ds.cads[int(row["obj_id"])]["cad_path"], np.asarray(row["intrinsic"]).reshape(3, 3),
                                 row["depth_path"], pose[None], pose)
            gt_vsd.append(float(vsd.vsd_frame_error(frame, renderer_backend="numpy")[0]))
        auto = vsd.make_renderer(ds.cads[1]["cad_path"], "auto").backend
        ok = len(ds) == n == sum(BOP_FRAMES) * BOP_OBJECTS and max(gt_vsd) == 0.0
        print(f"  (a) T-LESS-layout root: {len(BOP_FRAMES)} scenes, {sum(BOP_FRAMES)} frames of {BOP_HW[1]}x{BOP_HW[0]}, "
              f"{n} instances of {BOP_OBJECTS} box CADs, written in {t_write:.1f} s; all {len(ds)} read as test items; "
              f"GT-pose VSD over every instance max {max(gt_vsd):.3g} (want 0; numpy rasteriser, "
              f"{1e3 * (time.perf_counter() - t0) / n:.1f} ms an instance); make_renderer('auto') takes {auto} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("phase 12 (a): the BOP root or its host geometry is wrong")

        # (b) cli.export of seeded reference-format weights
        cfg = load_config(None, overrides).model
        seeded = build_task(cfg, dev, torch.Generator().manual_seed(121))
        paths = {k: os.path.join(tmp, name) for k, name in
                 (("unet", "reference_unet.pth"), ("vae", "sd_vae.bin"), ("ckpt", "nope_bop.pth"))}
        torch.save({"state_dict": {f"u_net.{k}": v.cpu() for k, v in seeded.unet.state_dict().items()}}, paths["unet"])
        torch.save({k: v.cpu() for k, v in seeded.vae.state_dict().items()}, paths["vae"])
        t0 = time.perf_counter()
        export.main(["--out", paths["ckpt"], "--unet", paths["unet"], "--vae", paths["vae"], "--device", device_flag,
                     *overrides])
        t_export = time.perf_counter() - t0
        task = build_task(cfg, dev, torch.Generator().manual_seed(0))
        restore_params(paths["ckpt"], task)
        same = all(torch.equal(a, b) for m, w in ((task.unet, seeded.unet), (task.vae, seeded.vae))
                   for a, b in zip(m.state_dict().values(), w.state_dict().values()))
        print(f"  (b) cli.export.main --unet (reference format, u_net. keys) --vae (diffusers .bin) on {device_flag}: "
              f"{os.path.getsize(paths['ckpt']) / 1e9:.2f} GB in {t_export:.1f} s; restore_params gives the seeded "
              f"weights bitwise: {same} {'ok' if same else 'FAIL'}")
        if not same:
            raise RuntimeError("phase 12 (b): the exported checkpoint does not restore the weights")
        del seeded

        # (c) cli.test_bop.main, fp32, the bank streamed in chunks and made whole
        flags = ["--renderer", "numpy", "--device", device_flag, "--num-workers", "0"]  # flags before overrides
        base = [*overrides, f"model.checkpoint_path={paths['ckpt']}", f"data.datasets.tless.root_dir={root}",
                "data.datasets.tless.split=test_primesense", f"machine.batch_size={BOP_BATCH}", "machine.num_workers=4"]
        runs, total = {}, {fn.__name__: 0 for fn in counters}
        for chunk in (BOP_CHUNK, None):
            record = {"card_ms": [], "vsd_ms": [], "sim": [], "idx": []}
            for fn in counters:
                fn.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with bop_clocks(torch, record):
                scores = test_bop.main(flags + (["--chunk-size", str(chunk)] if chunk else []) + base
                                       + [f"save_dir={os.path.join(tmp, f'out_{chunk}')}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counters}
            for k, v in launches.items():
                total[k] += v
            peak = torch.cuda.max_memory_allocated() / 2**30
            runs[chunk] = (scores, torch.cat(record["sim"]), torch.cat(record["idx"]))
            batches = len(record["card_ms"])
            ok = (set(scores) == VSD_KEYS and np.isfinite(list(scores.values())).all() and all(launches.values())
                  and batches == -(-n // BOP_BATCH) and len(runs[chunk][1]) == n)
            print(f"  (c) cli.test_bop.main fp32, chunk_size {chunk}: {n} queries in {wall:.2f} s "
                  f"({n / wall:.2f} img/s, model build and checkpoint load included); per batch of {BOP_BATCH} "
                  f"(the last of {n - (batches - 1) * BOP_BATCH}): the card {np.mean(record['card_ms']):.1f} ms "
                  f"(bank + retrieval, {min(record['card_ms']):.1f}-{max(record['card_ms']):.1f}), VSD on the host "
                  f"{np.mean(record['vsd_ms']):.1f} ms; peak {peak:.2f} GiB; launches {launches}; "
                  f"top-1 VSD recall@0.3 {scores['top 1, vsd_scores 0.3']:.1f}, median {scores['top 1, vsd_median']:.3f} "
                  f"{'ok' if ok else 'FAIL'} [{smi}]")
            if not ok:
                raise RuntimeError(f"phase 12 (c): cli.test_bop chunk_size {chunk} failed its checks")
        (s_a, sim_a, idx_a), (s_b, sim_b, idx_b) = runs[BOP_CHUNK], runs[None]
        rel, decided, same, ok = _topk_check(torch, sim_a, idx_a, sim_b, idx_b, idx_b.shape[1], CPU_SIM_RTOL)
        ok = ok and rel <= CPU_SIM_RTOL and s_a == s_b
        print(f"  (c) streamed vs whole: similarity rel {rel:.2e} (tol {CPU_SIM_RTOL:.0e}), top-5 equal in {same} of {n} rows ({decided} decided "
              f"at {CPU_SIM_RTOL:.0e}); scores equal: {s_a == s_b} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("phase 12 (c): the streamed bank and the whole bank disagree")
        out["launches"] = total
        out["times"] = bop_kernel_times(torch, smi, dev, k3_calls, k2_calls, check)

        # (d) one batch's retrieval against the plain ops on the card and against the CPU
        items = BOPDataset(root, None, "test_primesense", img_size=cfg.img_size)
        batch = collate([items[i] for i in range(BOP_BATCH)])
        q, r, rel6 = (torch.from_numpy(batch[k]).to(dev) for k in ("query", "reference", "all_relativeR"))
        with torch.no_grad():
            sim_k, idx_k = task.retrieval(q, task.generate_template_bank(r, rel6, chunk_size=BOP_CHUNK))
            with plain_ops(), plain_k1():
                sim_p, idx_p = task.retrieval(q, task.generate_template_bank(r, rel6, chunk_size=BOP_CHUNK))
        rel, decided, same, ok = _topk_check(torch, sim_k, idx_k, sim_p, idx_p, idx_p.shape[1], CPU_SIM_RTOL)
        cli_equal = torch.equal(sim_k.cpu(), sim_a[:BOP_BATCH])
        print(f"  (d) batch 0 (B={BOP_BATCH}, N={FULL_N}, chunks of {BOP_CHUNK}) vs K1-K3 plain on the card: similarity "
              f"rel {rel:.2e} (tol {CPU_SIM_RTOL:.0e}), top-5 equal in {same} of {BOP_BATCH} ({decided} decided); "
              f"bitwise the CLI's batch 0: {cli_equal} {'ok' if ok and rel <= CPU_SIM_RTOL else 'FAIL'}")
        if not (ok and rel <= CPU_SIM_RTOL):
            raise RuntimeError("phase 12 (d): the kernels disagree with their plain versions on the BOP path")
        t0 = time.perf_counter()
        cpu = PoseConditionalTask(copy.deepcopy(task.unet).cpu(), copy.deepcopy(task.vae).cpu(), task.config)
        with torch.no_grad():
            sim_c, idx_c = cpu.retrieval(q[:1].cpu(), cpu.generate_template_bank(r[:1].cpu(), rel6[:1].cpu(),
                                                                                  chunk_size=BOP_CHUNK))
        rel, decided, same, ok = _topk_check(torch, sim_k[:1].cpu(), idx_k[:1], sim_c, idx_c, idx_c.shape[1],
                                               CPU_SIM_RTOL)
        print(f"  (d) query 0 vs the CPU path (plain ops, {FULL_N} templates in chunks of {BOP_CHUNK}): similarity rel "
              f"{rel:.2e} (tol {CPU_SIM_RTOL:.0e}), top-5 equal: {bool(same)} (decided: {bool(decided)}); "
              f"{time.perf_counter() - t0:.1f} s {'ok' if ok and rel <= CPU_SIM_RTOL else 'FAIL'}")
        if not (ok and rel <= CPU_SIM_RTOL):
            raise RuntimeError("phase 12 (d): the card disagrees with the CPU path on the BOP path")
        del cpu, items, batch, q, r, rel6

        # (e) the Objaverse and bop_texture training loaders, one fp32 step each
        t0 = time.perf_counter()
        obj_root = os.path.join(tmp, "objaverse")
        write_objaverse_root(obj_root)
        members = {"hb": os.path.join(tmp, "hb"), "icbin": os.path.join(tmp, "icbin")}
        for i, path in enumerate(members.values()):
            write_bop_root(path, split="train_pbr", frames=(2, 2), seed=30 + i)
        ov = ["train_data_name=bop_texture,objaverse", "data.datasets.objaverse.name=objaverse",
              f"data.datasets.objaverse.root_dir={obj_root}", "data.datasets.bop_texture.name=bop_texture",
              f"machine.batch_size={BOP_TRAIN_BATCH}", "machine.num_workers=4", *overrides]
        ov += [f"data.datasets.{m}.{k}" for m, path in members.items() for k in ("name=bop", f"root_dir={path}")]
        tcfg = load_config(None, ov)
        tcfg.data.datasets["bop_texture"].extra = {"members": list(members)}
        loaders = builder.build_train_loaders(tcfg)
        t_data = time.perf_counter() - t0
        unet = copy.deepcopy(task.unet)
        state = train_state.TrainState(0, unet, task.vae, optim.make_optimizer(unet.parameters(), warm_up_steps=0))
        step = train_state.make_train_step(PoseConditionalTask(unet, task.vae, task.config), half_precision=False)
        for name, loader in loaders.items():
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(iter(loader)).items()}
            t0 = time.perf_counter()
            m = train_state.to_numpy_metrics(step(state, {name: batch})[1])
            t_step = time.perf_counter() - t0
            ok = np.isfinite(m["loss/train_avg"]) and m["loss/train_avg"] > 0
            print(f"  (e) {name}: {len(loader.dataset)} training items, {len(loader)} batches of {BOP_TRAIN_BATCH}; one "
                  f"fp32 train step: loss {m['loss/train_avg']:.5f} in {1e3 * t_step:.1f} ms {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"phase 12 (e): the {name} train step's loss is not finite")
        print(f"  (e) roots and loaders built in {t_data:.1f} s; the train state took {state.step} steps")
        del unet, state, step, loaders, task
    torch.cuda.empty_cache()
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")
    return out


@contextlib.contextmanager
def hidden(*names):
    """Imports of ``names`` raise ImportError inside the block, as on a host
    without those packages; their modules are back afterwards."""
    saved = {n: sys.modules[n] for n in names if n in sys.modules}
    sys.modules.update({n: None for n in names})
    try:
        yield
    finally:
        for n in names:
            if n in saved:
                sys.modules[n] = saved[n]
            else:
                del sys.modules[n]


def median_host_ms(calls) -> float:
    """Median host time of each call in ``calls``, once each, in ms."""
    times = []
    for call in calls:
        t0 = time.perf_counter()
        call()
        times.append(1000 * (time.perf_counter() - t0))
    return float(np.median(times))


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
    from nope_tpu_torch.native import build as native_builder
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
    # the native data-plane library (phase 8) builds with g++ beside nvcc
    builder_pool = ThreadPoolExecutor(max_workers=1)
    native_build = builder_pool.submit(native_builder.build)
    builder_pool.shutdown(wait=False)
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
    for items in CHECK_ITEMS:
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
    # past the grid's 65,535 y extent: K3 at its smallest block shape (4x4),
    # held on samples both sides of 65,535; K1 with a bank per query
    small = min((sh for sh in k3_shapes if sh[0] == 4), key=lambda sh: sh[2] + sh[3])
    x, emb, params = k3_inputs(torch, small, BIG_B, dev, torch.bfloat16, dgen)
    got = fr.resnet_block(x, emb, params, small[6])
    rows = torch.cat([torch.arange(8), torch.arange(BIG_B - 72, BIG_B)]).to(dev)
    want = fr.resnet_block_plain(x[rows].float(), None if emb is None else emb[rows].float(),
                                 {k: v.float() for k, v in params.items()}, small[6])
    check("K3", f"B={BIG_B} {small[0]}x{small[1]} {small[2]}->{small[3]} rows 0-7, {BIG_B - 72}-{BIG_B - 1}",
          got[rows], want, "bfloat16")
    del x, emb, params, got, want
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(BIG_B, LATENT, LATENT, 4, generator=dgen, device=dev).to(dtype)
        bank = torch.randn(BIG_B, 1, LATENT, LATENT, 4, generator=dgen, device=dev).to(dtype)
        check("K1", f"B={BIG_B} N=1 bank per query", sim.reference_similarity(q, bank),
              sim.reference_similarity_plain(q.float(), bank.float()), str(dtype).split(".")[-1])
        del q, bank
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b, n, lead, c, side in K1_CHANNELS:
            q = torch.randn(b, side, side, c, generator=gen).to(dev, dtype)
            bank = torch.randn(lead, n, side, side, c, generator=gen).to(dev, dtype)
            route = "tiled" if sim.vector_route(q, bank) else "scalar"
            got = sim.reference_similarity(q, bank)
            check("K1", f"B={b} N={n} lead {lead} C={c} {side}x{side} {route}", got,
                  sim.reference_similarity_plain(q.float(), bank.float()), dn)
            if not torch.equal(got, sim.reference_similarity(q, bank)):
                raise RuntimeError(f"K1 B={b} N={n} lead {lead} C={c} {dn}: two launches on the same inputs differ")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"  K3 bf16: two launches bitwise equal at all {len(k3_shapes) * len(K3_BATCHES) + len(big_k3) * len(CHECK_ITEMS)}"
          f" (shape, batch)")
    print(f"  K1 and K2, both dtypes: two launches bitwise equal at all {len(K1_SHAPES) + len(K1_CHANNELS)} and "
          f"{len(K2_ITEMS) * len(k2_tokens)} shapes; K2 bf16 also at {len(CHECK_ITEMS) * len(k2_tokens)}")

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
        for b, n, lead in K1_TIMED_C8:  # the template encoder's 8-channel descriptors
            q = torch.randn(b, LATENT, LATENT, 8, generator=gen).to(dev, dtype)
            bank = torch.randn(lead, n, LATENT, LATENT, 8, generator=gen).to(dev, dtype)
            t_k = cuda_ms(torch, lambda: sim.reference_similarity(q, bank), 20, warmup=3)
            t_d = device_ms(torch, lambda: sim.reference_similarity(q, bank))
            t_p = cuda_ms(torch, lambda: sim.reference_similarity_plain(q, bank), 20, warmup=3)
            b1 = bound(f32_ops=float(b * n * LATENT * LATENT) * (3 * 8 + 3),
                       nbytes=float(q.numel() + bank.numel()) * q.element_size() + 4 * b * n)
            print(f"  K1 B={b:<3} N={n:<3} bank lead {lead:<3} C=8 {dn:<8} kernel {t_k:8.4f} ms (device alone "
                  f"{t_d:.4f}) plain {t_p:8.3f} ms bound {b1[0]:.4f} ms ({b1[1]}) share {100 * b1[0] / t_k:.1f}% "
                  f"(device alone {100 * b1[0] / t_d:.1f}%)")
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
    refinement_timings(torch, smi, estimators[("bfloat16", FAST_N)], task32, half, requests, grids, dev)
    b, n, chunk = EVAL["full"]
    print(f"phase 5b: profiler windows on {smi}")
    profile_window(torch, f"eval step, full protocol B={b} N={n} chunk_size {chunk} (bf16 retrieval, fp32 loss)",
                   lambda: task32.eval_geodesic_step(eval_dev["full"], chunk_size=chunk, infer_task=half), top=10)
    # 4 steps: each step repeats the same kernels; 24 would only lengthen the trace
    profile_window(torch, f"estimate bfloat16 N={FAST_N} B={QUERIES} refine_steps=4",
                   lambda: estimators[("bfloat16", FAST_N)].estimate("object", requests[0], refine_steps=4), top=10)

    # -- phase 7: refinement ---------------------------------------------------
    rf = refinement_phase(torch, dev, task32, half, estimators, cpu_est, ev["gallery"], grids, requests, counters,
                          k2_calls, k3_calls, gen)

    # -- phase 8: the evaluation CLI ---------------------------------------------
    cli_launches = cli_phase(torch, dev, smi, counters, task32, half, native_build)

    # -- phase 9: training -------------------------------------------------------
    tr = training_phase(torch, dev, smi, counters, task32, unet_cpu, vae_cpu, (len(k3_calls), len(k2_calls)))

    # -- phase 10: the parallel paths ---------------------------------------------
    par = parallel_phase(torch, dev, smi, counters, task32, half, grids, tr["timings"]["step_ms"])

    # -- phase 11: the model zoo ------------------------------------------------------
    del estimators, cpu_est, eval_dev, half  # the flagship's banks and copies: phase 11 builds its own tasks
    for key in ("gallery", "batches", "half"):
        ev.pop(key, None)
    torch.cuda.empty_cache()
    zoo = model_zoo_phase(torch, dev, smi, counters)

    # -- phase 12: the BOP / T-LESS path ---------------------------------------------------
    bop = bop_phase(torch, dev, smi, counters, k3_calls, k2_calls, check)

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
         "eval_launches": ev["launches"][fn.__name__], "refine_launches": rf["launches"][fn.__name__],
         "cli_launches": cli_launches[fn.__name__], "train_launches": tr["launches"][fn.__name__],
         "train_recomputes": tr["recomputes"][k], "unet_weight_grad_rel": tr["grad"] if k != "K1" else None,
         "parallel_launches": {"a": par["a"][fn.__name__], "b": par["b"][fn.__name__]},
         "zoo_launches": {name: zoo[name][fn.__name__] for name in ZOO_EVAL},
         "bop_launches": bop["launches"][fn.__name__],
         **({"bop_fp32": {str(items): t for items, t in bop["times"][k].items()}} if k in bop["times"] else {}),
         **({"refine_recomputes": rf["recomputes"][k], "backward_max_rel": rf["backward"][k],
             "unet_pose_grad_rel": rf["unet_grad"]} if k in rf["backward"] else {})}
        for name, k, src, rep, fn in table
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
