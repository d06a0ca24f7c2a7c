// K3: the U-Net's ResnetBlock, split at the GroupNorm boundary.
//
// Replaces nope_tpu/ops/experimental/fused_resnet.py::_make_kernel
// (with _conv3x3 and _gn_silu; pallas_call in resnet_block_pallas):
//
//   a   = SiLU(GN(conv3x3(x) + b1)) + emb
//   out = SiLU(GN(conv3x3(a) + b2)) + (conv1x1(x) + rb  or  x)
//
// GroupNorm takes per-(sample, group) statistics of a conv output.  The
// TPU kernel holds one sample's whole activation in VMEM; on an H100 one
// 32x32x192 float32 sample is 768 KiB, more than the 227 KB of shared
// memory a block may use.  So in bf16 a thread-block cluster of the tiles
// that make one sample (8 at 32x32) merges their statistics over
// distributed shared memory and normalises in the conv's epilogue, or a
// tile of whole samples does so alone; where a conv's plan cannot (split
// K, a register epilogue, float32, other groups), the block runs as a
// chain of kernels through a float32 pre-norm output.
//
// The tensor-core route (bfloat16, the serving dtype, and float32) --
// what bounds it on an H100 is the convolutions' operations (~29 GFLOP a
// sample over the U-Net's 22 blocks, against ~1 MB of activations), so
// they run on the tensor cores:
//
//   conv_wgmma     implicit-GEMM conv, M = B*H*W pixels, N = Co, K =
//                  ks*ks*Cin ordered (tap, ci), float32 accumulators.  A
//                  K-slice is one tap and one 128-byte row of a shifted
//                  NHWC pixel (64 bf16 or 32 float32 channels); both
//                  operands land in a ring of 128-byte-swizzled slots,
//                  the weight tile by TMA.  The N tile is 192 columns and
//                  holds whole GroupNorm groups (cg in {24, 48, 96, 192}),
//                  so the epilogue adds the bias and takes per tile a
//                  partial (count, mean, M2) for every (sample, group) it
//                  touches: fused, it merges them (its cluster's, in tile
//                  order) and stores SiLU(GN) + emb or + res in bf16;
//                  chained, it stores the float32 pre-norm output and the
//                  partials for gn_finalize and gn_silu.  Few
//                  tiles (the 4x4 to 16x16 stages at small batch) split K
//                  over blocks; splitk_reduce sums the splits in a fixed
//                  order.  The 1x1 residual is the same kernel with one
//                  tap.  Two mainloops:
//                  bf16 (conv_wgmma_tma): A by TMA too.  The activation is
//                  a 4-D tiled tensor map (Cin, W, H, B); a tile of 64 or
//                  128 rows holds whole image rows of one sample (32x32: 2
//                  or 4 rows; 16x16: 4 or 8) or whole samples (8x8: 1 or
//                  2; 4x4: 4 or 8), so its A rows for a tap are one box of
//                  (64 channels, W, rows, samples) at the tap's shift, and
//                  the box's zero fill outside the tensor is the conv's
//                  padding (and the samples past B of a ragged last
//                  tile).  The tiled map was chosen over TMA's im2col mode
//                  because the flagship's tiles are such boxes and its
//                  coordinates are plain (x, y, sample) shifts, checked on
//                  the CPU against im2col.  A persistent grid, one block
//                  an SM: one producer thread keeps a ring of K-slices of
//                  A and B in flight across the block's tiles, each slot
//                  with a full and an empty mbarrier; one or two consumer
//                  warpgroups wait on full, issue the slice's wgmmas,
//                  commit, wait until only that group is in flight
//                  (wait_group 1) and release the previous slice's slot:
//                  the tensor cores do not drain between slices and no
//                  block-wide barrier stands in the mainloop.  The grid is
//                  of clusters along M: a fused sample's tiles, or 2
//                  neighbouring tiles; where the tiles fill the card twice
//                  over, pairs of a cluster multicast the weight tile,
//                  half from each.  Two epilogues: an unsplit tile of
//                  fewer than 128 K-slices stages its sums in shared
//                  memory and goes on, while three finisher warps
//                  complete the tile (finish_staged; fused, with the
//                  cluster's exchange of partials by st.async and the
//                  normalising, norm_staged) beside a ring of 3-5; longer
//                  tiles finish from their registers beside a ring of 5,
//                  where each group is whole 8-column blocks and an N
//                  tile holds at most 8 groups (other groups stage), and
//                  keep the chain, and so do split tiles, which store raw
//                  sums for splitk_reduce.  (A 256-row tile, two m64n192
//                  products per consumer, spilled its 192 accumulators a
//                  thread and ran 2.5-3.5x slower; a fused register
//                  epilogue, run between mainloops, cost more than the
//                  chain's separate pass: PERF.md.)
//                  float32 (conv_wgmma, 3xTF32, below): every thread
//                  gathers A rows by 16-byte cp.async, zero-filled for the
//                  halo, then splits them; the block meets at a barrier
//                  every K-slice and drains its wgmmas, as its running
//                  totals need (tiles of 64 or 128 rows by 192 columns,
//                  or by 128 for a conv without partials);
//   gn_finalize    (chained convs) merges a (sample, group)'s partials in
//                  tile order with Chan's formula (no E[x^2] - mean^2
//                  cancellation) into per-channel tables;
//   gn_silu        as below, storing the first Block's activation in the
//                  block's dtype: in bf16 the second conv's operand,
//                  rounded as the TPU's MXU rounded its float32 scratch at
//                  default precision; in float32 kept whole.  The fused
//                  epilogue shares their arithmetic (chan_merge,
//                  norm_rstd, gn_act) and equals the chain bitwise.
//
// bfloat16: wgmma m64n192k16 on bf16 operands (989 TFLOP/s).  Per K-slice a
// 128 x 192 tile reads 40 KB from L2 for 3.1 MFLOP (77 operations a byte).
// Fused, a block's float32 pre-norm outputs never reach device memory (in
// the chain, gn_silu was ~16% of K3's device time at 3,328 items: PERF.md).
//
// float32, 3xTF32 (Cin % 32 == 0, Co % 8 == 0, cg | 192): the same
// kernel on tf32 operands, wgmma m64n192k8.  Each operand is split as
// a = hi + lo, hi = tf32(a) rounded to nearest (ties away from zero), lo
// = a - hi exact, which the tensor cores read with its low 13 mantissa
// bits dropped; three products lo*hi, hi*lo, hi*hi (small terms first)
// go into the same float32 accumulators.  Each product is exact and its
// dropped terms are ~2^-21 of a*b.  The tensor cores' own accumulation
// truncates, so each K-slice (32 channels of a tap) sums from zero and is
// added to a running total in registers with round-to-nearest: the sums
// keep float32's accuracy and the route holds the exact float32 block
// within 1e-4 (the TPU's float32 K3 rounded its conv operands to bf16 in
// one pass).  What bounds it is 3 x the conv products at 495 TFLOP/s
// (TF32), 2.5x the CUDA cores' 67 TFLOP/s for one product.  The weights
// arrive split, as two (Co, K) planes packed once per parameter; each
// thread splits the A chunks it copied (cvt.rna) in shared memory, hi in
// place and lo into a second slot of the same swizzle, so a stage holds A
// and B twice: 64 KB at 64 rows (a ring of 3) and 80 KB at 128 rows (a
// ring of 2; 192-row tiles leave no registers for the totals).  The
// GroupNorm statistics come from the epilogue as in bf16: the conv
// output is written once and read once more, by gn_silu.  A launch
// without partials (conv_tf32x3 alone: the float32 SD-VAE's convs) takes
// an N tile of 128 where Cout fills it better (128, 256, 512 leave 1/3,
// 1/3 and 1/9 of 192-column tiles idle), in 48 KB stages at 64 rows (a
// ring of 4) and 64 KB at 128 (a ring of 3).  There the loads, not the
// drained tensor cores, set the pace: a second set of accumulators, to keep
// one slice in flight while the last is summed, left the ring one slice
// less ahead and ran 10% slower; 128-row tiles, which share each B tile
// over twice the rows, ran 20% faster than 64 (PERF.md).
//
// float32 (exact, no TF32) and bf16 at widths neither tensor-core conv
// takes -- on the CUDA cores:
//
//   conv_nhwc      implicit-GEMM conv (64 x 64 tiles, 4 x 4 per thread),
//                  + bias, float32 out;
//   group_stats    two-pass mean and variance per (sample, group);
//   gn_silu        normalise + affine + SiLU, whose epilogue adds emb
//                  (after the first conv) or the residual (after the
//                  second) and stores in the output dtype.
//
// Every sum is taken in a fixed order, so a launch is bitwise repeatable.
#include <cuda.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kConvThreads = 256;
constexpr int kStatsThreads = 512;
constexpr int kEltThreads = 1024;  // at most; gn_silu uses C / 4 x ny

// out[m, co] = bias[co] + sum_{tap, ci} x[pixel(m) + shift(tap), ci] * w[tap, ci, co]
// x: (B, H, W, Cin) NHWC; w: (ks * ks * Cin, Cout); out: (B * H * W, Cout) float32.
__global__ void __launch_bounds__(kConvThreads)
conv_nhwc_kernel(const void* __restrict__ x, const void* __restrict__ w,
                 const void* __restrict__ bias, float* __restrict__ out, int B, int H,
                 int W, int Cin, int Cout, int ks, int xdt, int wdt) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = B * H * W, K = ks * ks * Cin, pad = ks / 2;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // the A tile: this thread loads column k = tid % kBK of rows ty + 16 i
  const int a_k = tid % kBK;
  int pb[4], py[4], px[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m < M) {
      pb[i] = m / (H * W);
      const int r = m % (H * W);
      py[i] = r / W;
      px[i] = r % W;
    } else {
      pb[i] = -1;
      py[i] = px[i] = 0;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int k = k0 + a_k;
    const int tap = k / Cin, ci = k % Cin;
    const int dy = tap / ks - pad, dx = tap % ks - pad;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      const int yy = py[i] + dy, xx = px[i] + dx;
      if (k < K && pb[i] >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = load_f(x, ((static_cast<size_t>(pb[i]) * H + yy) * W + xx) * Cin + ci, xdt);
      As[a_k][ty + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kConvThreads;
      const int kl = idx / kBN, nl = idx % kBN;
      const int kk = k0 + kl, n = n0 + nl;
      Bs[kl][nl] = (kk < K && n < Cout) ? load_f(w, static_cast<size_t>(kk) * Cout + n, wdt)
                                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kl = 0; kl < kBK; ++kl) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kl][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kl][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) out[static_cast<size_t>(m) * Cout + n] = acc[i][j] + load_f(bias, n, wdt);
    }
  }
}

// 4 consecutive elements (16 bytes float32, 8 bytes bfloat16), i % 4 == 0
__device__ __forceinline__ float4 load4(const void* p, size_t i, int dt) {
  if (dt == DT_F32) return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
  const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(void* p, size_t i, int dt, float4 v) {
  if (dt == DT_F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = v;
    return;
  }
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = raw;
}

// The GroupNorm arithmetic that the chain (gn_finalize, gn_silu) and the bf16
// conv's fused epilogue share, with every rounding explicit (no FMA
// contraction left to the compiler), so that both give the same bits.
//
// Chan's merge of a partial (nb, mb, qb) = (count, mean, M2) into (n, mu, m2)
__device__ __forceinline__ void chan_merge(float& n, float& mu, float& m2, float nb, float mb, float qb) {
  const float nt = __fadd_rn(n, nb), d = __fsub_rn(mb, mu);
  mu = __fadd_rn(mu, __fmul_rn(d, __fdiv_rn(nb, nt)));
  m2 = __fadd_rn(m2, __fadd_rn(qb, __fmul_rn(__fmul_rn(d, d), __fdiv_rn(__fmul_rn(n, nb), nt))));
  n = nt;
}

// 1 / sqrt(var + eps), var = m2 / n
__device__ __forceinline__ float norm_rstd(float m2, float n, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(m2, n), eps)));
}

// y / (1 + e^-y) by the fast intrinsics (ex2 and rcp, within a few ulp):
// branch-free, so a warp's elements interleave (IEEE division puts each in
// a branch region of its own, which the fused epilogue's few warps could
// not hide)
__device__ __forceinline__ float silu(float y) { return __fdividef(y, __fadd_rn(1.f, __expf(-y))); }

// SiLU((v - mu) * scale + beta) + em; scale = rstd * gamma (__fmul_rn)
__device__ __forceinline__ float gn_act(float v, float mu, float scale, float beta, float em) {
  return __fadd_rn(silu(__fmaf_rn(__fsub_rn(v, mu), scale, beta)), em);
}

// GroupNorm of (sample b, group g) as per-channel tables the normalise
// pass reads: mean[b, c] = mu, scale[b, c] = rs * gamma[c]
__device__ __forceinline__ void write_norm_tables(float* mean, float* scale, const void* gamma,
                                                  int pdt, int b, int g, int C, int cg,
                                                  float mu, float rs, int first, int step) {
  for (int c = g * cg + first; c < (g + 1) * cg; c += step) {
    mean[static_cast<size_t>(b) * C + c] = mu;
    scale[static_cast<size_t>(b) * C + c] = __fmul_rn(rs, load_f(gamma, c, pdt));
  }
}

// One block per (sample, group): mean, then the mean of squared
// deviations from it (two passes; no E[x^2] - mean^2 cancellation).
__global__ void __launch_bounds__(kStatsThreads)
group_stats_kernel(const float* __restrict__ h, const void* __restrict__ gamma, int pdt,
                   float* __restrict__ mean, float* __restrict__ scale, int HW, int C, int G,
                   float eps) {
  __shared__ float scratch[32];
  const int b = blockIdx.x / G, g = blockIdx.x % G, cg = C / G;
  const size_t count = static_cast<size_t>(HW) * cg;
  const float* base = h + static_cast<size_t>(b) * HW * C + static_cast<size_t>(g) * cg;
  float s = 0.f;
  for (size_t e = threadIdx.x; e < count; e += kStatsThreads)
    s += base[(e / cg) * C + e % cg];
  const float mu = block_sum(s, scratch) / static_cast<float>(count);
  float v = 0.f;
  for (size_t e = threadIdx.x; e < count; e += kStatsThreads) {
    const float d = base[(e / cg) * C + e % cg] - mu;
    v += d * d;
  }
  const float var = block_sum(v, scratch) / static_cast<float>(count);
  write_norm_tables(mean, scale, gamma, pdt, b, g, C, cg, mu, 1.f / sqrtf(var + eps), threadIdx.x,
                    kStatsThreads);
}

// out = SiLU((h - mean[b, c]) * scale[b, c] + beta[c]) [+ emb[b, c]] [+ res]
// Block (C / 4, ny) covers `rows` pixels of samples blockIdx.y,
// blockIdx.y + gridDim.y, ... (the grid's y extent is capped at 65,535,
// so a block strides over the samples); thread (tx, ty) owns channels
// 4 tx .. 4 tx + 3 and every ny-th pixel, so each load and store is 4
// channels wide and the tables are read once a sample.
__global__ void __launch_bounds__(kEltThreads)
gn_silu_kernel(const float* __restrict__ h, const float* __restrict__ mean,
               const float* __restrict__ scale, const void* __restrict__ beta, int pdt,
               const void* __restrict__ emb, int edt, const void* __restrict__ res, int rdt,
               void* __restrict__ out, int odt, int B, int HW, int C, int rows) {
  const int c = 4 * threadIdx.x;
  const float4 be = load4(beta, c, pdt);
  const int p0 = static_cast<int>(blockIdx.x) * rows, p1 = min(HW, p0 + rows);
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const size_t bc = static_cast<size_t>(b) * C + c;
    const float4 mu = *reinterpret_cast<const float4*>(mean + bc);
    const float4 sc = *reinterpret_cast<const float4*>(scale + bc);
    const float4 em = emb != nullptr ? load4(emb, bc, edt) : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = p0 + static_cast<int>(threadIdx.y); p < p1; p += static_cast<int>(blockDim.y)) {
      const size_t i = (static_cast<size_t>(b) * HW + p) * C + c;
      const float4 v = *reinterpret_cast<const float4*>(h + i);
      float4 y = make_float4(gn_act(v.x, mu.x, sc.x, be.x, em.x), gn_act(v.y, mu.y, sc.y, be.y, em.y),
                             gn_act(v.z, mu.z, sc.z, be.z, em.z), gn_act(v.w, mu.w, sc.w, be.w, em.w));
      if (res != nullptr) {
        const float4 r = load4(res, i, rdt);
        y = make_float4(__fadd_rn(y.x, r.x), __fadd_rn(y.y, r.y), __fadd_rn(y.z, r.z), __fadd_rn(y.w, r.w));
      }
      store4(out, i, odt, y);
    }
  }
}

// ---------------------------------------------------------------------------
// GroupNorm + SiLU of channels-last float32 or bf16 activations, with an
// addend before the statistics or a FiLM after them: the bf16 res blocks of
// the LDM and the ADM (models/ldm_unet.py LDMResBlock) and the float32
// SD-VAE's norms before its 3xTF32 convs (models/vae.py)
// ---------------------------------------------------------------------------
//
// Replaces no TPU kernel: JAX computes these blocks as XLA ops.  Added
// because in PyTorch nn.GroupNorm hands a channels-last tensor back NCHW,
// so each conv after it paid cuDNN's two layout transposes, and the norm,
// the FiLM and the SiLU were a bf16 pass each (PERF.md).  The pair serves
// the LDM's and the ADM's bf16 res blocks and the float32 SD-VAE's
// GroupNorm + SiLU before its 3xTF32 convs: x and the output are float32
// or bf16 (one dtype code), statistics and tables float32.  What bounds
// the pair is bytes: the statistics read x once, the apply kernel reads it
// once more and writes the output, 3 x's element size an element.
//
//   gn_nhwc_stats  blocks of (C / V, ny) threads, ny = 256 / (C / V): a
//                  thread loads one 16-byte vector of V channels (8 bf16
//                  or 4 float32) of kNormRows pixels a step, so each warp
//                  reads whole pixel rows.  A step's values stay in
//                  registers for two passes (its group means, then the
//                  squared deviations from them); lane g of warp 0 sums
//                  group g's threads in a fixed order and merges the step
//                  into the group's (count, mean, M2) by Chan's formula.
//                  A block takes `span` pixels of one sample and writes a
//                  partial a group; a sample splits into spans only where
//                  the batch alone would not fill the card.
//   gn_nhwc_apply  the same blocks over the same spans: lane g merges the
//                  sample's partials in span order; each thread folds the
//                  affine, the addend e and the FiLM (scale, shift) into
//                  m, a, d for its V channels,
//                      m = mean - e,  a = rstd·gamma·(1 + scale)
//                      d = beta·(1 + scale) + shift,
//                  and streams out = SiLU((x - m)·a + d) in x's dtype, 16
//                  bytes a load and a store.  x is centred before the
//                  scale, so a group whose mean is far above its spread
//                  loses no more than nn.GroupNorm does.
// No atomics: every sum is in a fixed order, so a launch repeats bitwise.

constexpr int kNormRows = 8;        // pixels a thread holds per step
constexpr int kNormThreads = 256;   // C / V threads across a pixel, ny pixels deep
constexpr int kNormMaxGroups = 32;  // the groups warp 0's lanes merge

// A thread's 16-byte vector of the pair, as kV float32 values
template <typename T>
struct NormVec;

template <>
struct NormVec<__nv_bfloat16> {
  static constexpr int kV = 8;
  static __device__ __forceinline__ void load(const uint4& raw, float (&v)[kV]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 store(const float (&v)[kV]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return raw;
  }
};

template <>
struct NormVec<float> {
  static constexpr int kV = 4;
  static __device__ __forceinline__ void load(const uint4& raw, float (&v)[kV]) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
  static __device__ __forceinline__ uint4 store(const float (&v)[kV]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

// Sum of red over group g's threads (vg vectors of each of ny pixel rows),
// in a fixed order
__device__ __forceinline__ float group_sum(const float* red, int g, int vg, int V, int ny) {
  float t = 0.f;
  for (int y = 0; y < ny; ++y)
    for (int q = g * vg; q < (g + 1) * vg; ++q) t = __fadd_rn(t, red[y * V + q]);
  return t;
}

// part[b, k, g] = (count, mean, M2) of group g of (x + addend[b]) over
// pixels [k·span, (k + 1)·span) of sample b
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
gn_nhwc_stats_kernel(const void* __restrict__ xv, const void* __restrict__ addend, int adt,
                     float* __restrict__ part, int B, int HW, int C, int G, int span, int splits) {
  const T* __restrict__ x = static_cast<const T*>(xv);
  constexpr int kV = NormVec<T>::kV;
  __shared__ float red[kNormThreads];
  __shared__ float gmean[kNormMaxGroups];
  const int V = blockDim.x, ny = blockDim.y, ty = threadIdx.y, tid = ty * V + threadIdx.x;
  const int c = kV * threadIdx.x, vg = C / (G * kV), g = threadIdx.x / vg;
  const int p0 = blockIdx.x * span, p1 = min(HW, p0 + span), rows = ny * kNormRows;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    float e[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j)
      e[j] = addend != nullptr ? load_f(addend, static_cast<size_t>(b) * C + c + j, adt) : 0.f;
    float n = 0.f, mu = 0.f, m2 = 0.f;  // lane g of warp 0: group g so far
    for (int t0 = p0; t0 < p1; t0 += rows) {
      const int valid = min(rows, p1 - t0);
      uint4 raw[kNormRows];
#pragma unroll
      for (int r = 0; r < kNormRows; ++r) {
        const int p = r * ny + ty;
        raw[r] = p < valid ? *reinterpret_cast<const uint4*>(x + (static_cast<size_t>(b) * HW + t0 + p) * C + c)
                           : make_uint4(0u, 0u, 0u, 0u);
      }
      float s[kV] = {};
#pragma unroll
      for (int r = 0; r < kNormRows; ++r) {
        if (r * ny + ty >= valid) continue;
        float v[kV];
        NormVec<T>::load(raw[r], v);
#pragma unroll
        for (int j = 0; j < kV; ++j) s[j] = __fadd_rn(s[j], __fadd_rn(v[j], e[j]));
      }
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < kV; ++j) t = __fadd_rn(t, s[j]);
      red[tid] = t;
      __syncthreads();
      const float cnt = static_cast<float>(valid) * static_cast<float>(vg * kV);  // a group's elements
      if (tid < G) gmean[tid] = __fdiv_rn(group_sum(red, tid, vg, V, ny), cnt);
      __syncthreads();
      const float m = gmean[g];
      float q[kV] = {};
#pragma unroll
      for (int r = 0; r < kNormRows; ++r) {
        if (r * ny + ty >= valid) continue;
        float v[kV];
        NormVec<T>::load(raw[r], v);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const float d = __fsub_rn(__fadd_rn(v[j], e[j]), m);
          q[j] = __fmaf_rn(d, d, q[j]);
        }
      }
      t = 0.f;
#pragma unroll
      for (int j = 0; j < kV; ++j) t = __fadd_rn(t, q[j]);
      red[tid] = t;
      __syncthreads();
      if (tid < G) chan_merge(n, mu, m2, cnt, gmean[tid], group_sum(red, tid, vg, V, ny));
      __syncthreads();  // red and gmean are rewritten by the next step
    }
    if (tid < G) {
      float* o = part + ((static_cast<size_t>(b) * splits + blockIdx.x) * G + tid) * 3;
      o[0] = n;
      o[1] = mu;
      o[2] = m2;
    }
  }
}

// out (x's dtype) = SiLU((x - m[b, c])·a[b, c] + d[b, c]) over the pixels of the stats kernel's
// spans; gamma, beta (C) of dtype pdt; addend (B, C) of dtype adt and film
// (B, 2C) = [scale | shift] of dtype fdt, each or both null
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
gn_nhwc_apply_kernel(const void* __restrict__ xv, const float* __restrict__ part,
                     const void* __restrict__ gamma, const void* __restrict__ beta, int pdt,
                     const void* __restrict__ addend, int adt, const void* __restrict__ film, int fdt,
                     void* __restrict__ outv, int B, int HW, int C, int G, int span, int splits,
                     float eps) {
  const T* __restrict__ x = static_cast<const T*>(xv);
  T* __restrict__ out = static_cast<T*>(outv);
  constexpr int kV = NormVec<T>::kV;
  __shared__ float stat[2 * kNormMaxGroups];
  const int V = blockDim.x, ny = blockDim.y, ty = threadIdx.y, tid = ty * V + threadIdx.x;
  const int c = kV * threadIdx.x, g = threadIdx.x / (C / (G * kV));
  const int p0 = blockIdx.x * span, p1 = min(HW, p0 + span), rows = ny * kNormRows;
  float gam[kV], bet[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    gam[j] = load_f(gamma, c + j, pdt);
    bet[j] = load_f(beta, c + j, pdt);
  }
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    if (tid < G) {
      float n = 0.f, mu = 0.f, m2 = 0.f;
      const float* p = part + (static_cast<size_t>(b) * splits * G + tid) * 3;
      for (int k = 0; k < splits; ++k, p += 3 * G) chan_merge(n, mu, m2, p[0], p[1], p[2]);
      stat[2 * tid] = mu;
      stat[2 * tid + 1] = norm_rstd(m2, n, eps);
    }
    __syncthreads();
    const float mu = stat[2 * g], rs = stat[2 * g + 1];
    float m[kV], a[kV], d[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const size_t bc = static_cast<size_t>(b) * C + c + j;
      m[j] = addend != nullptr ? __fsub_rn(mu, load_f(addend, bc, adt)) : mu;
      a[j] = __fmul_rn(rs, gam[j]);
      d[j] = bet[j];
      if (film != nullptr) {
        const size_t f = static_cast<size_t>(b) * 2 * C + c + j;
        const float s1 = __fadd_rn(1.f, load_f(film, f, fdt));
        a[j] = __fmul_rn(a[j], s1);
        d[j] = __fmaf_rn(d[j], s1, load_f(film, f + C, fdt));
      }
    }
    __syncthreads();  // stat is rewritten for the next sample
    for (int t0 = p0; t0 < p1; t0 += rows) {
      uint4 raw[kNormRows];
#pragma unroll
      for (int r = 0; r < kNormRows; ++r) {
        const int p = t0 + r * ny + ty;
        raw[r] = p < p1 ? *reinterpret_cast<const uint4*>(x + (static_cast<size_t>(b) * HW + p) * C + c)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int r = 0; r < kNormRows; ++r) {
        const int p = t0 + r * ny + ty;
        if (p >= p1) continue;
        float v[kV];
        NormVec<T>::load(raw[r], v);
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = silu(__fmaf_rn(__fsub_rn(v[j], m[j]), a[j], d[j]));
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * HW + p) * C + c) = NormVec<T>::store(v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core conv: bf16 operands, or float32 as three tf32 products
// ---------------------------------------------------------------------------

constexpr int kTileN = 192;               // N tile: whole groups for cg | 192
constexpr int kRowBytes = 128;            // one swizzled smem row: one K-slice
constexpr int kPitch = kTileN + 8;        // floats per row of the staged tile
constexpr int kEpiThreads = 1024;
constexpr int kSmemMax = 232448;          // shared memory a block may use (227 KB)
constexpr int kRegGroups = 8;             // the most groups the register epilogue's N tile holds
constexpr int kFuseSegs = 9;              // the most samples a tile normalises in its epilogue
constexpr int kMaxCluster = 8;            // the portable thread-block cluster size

// The A-by-TMA conv's ring holds at most NOPE_CONV_RING K-slices (5 hides
// the TMA's latency; scripts/k3_tiles.py builds other depths to sweep them)
#ifndef NOPE_CONV_RING
#define NOPE_CONV_RING 5
#endif

// A K-slice is one tap x kSlice channels (one 128-byte row); a wgmma step
// reads 32 bytes of every row.  (float32 operands arrive as two tf32
// planes, hi and lo, so a 3xTF32 stage holds A and B twice.)
template <typename T>
struct Operand;
template <>
struct Operand<__nv_bfloat16> {
  static constexpr int kSlice = 64;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Operand<float> {
  static constexpr int kSlice = 32;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO); the leading offset is unused
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// the 96 float32 accumulators of an m64n192 tile, as asm operands %0-%95
#define NOPE_ACC_REGS                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                         \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                                   \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                                 \
  " %24, %25, %26, %27, %28, %29, %30, %31,"                                 \
  " %32, %33, %34, %35, %36, %37, %38, %39,"                                 \
  " %40, %41, %42, %43, %44, %45, %46, %47,"                                 \
  " %48, %49, %50, %51, %52, %53, %54, %55,"                                 \
  " %56, %57, %58, %59, %60, %61, %62, %63,"                                 \
  " %64, %65, %66, %67, %68, %69, %70, %71,"                                 \
  " %72, %73, %74, %75, %76, %77, %78, %79,"                                 \
  " %80, %81, %82, %83, %84, %85, %86, %87,"                                 \
  " %88, %89, %90, %91, %92, %93, %94, %95}"
#define NOPE_ACC_OPERANDS(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),     \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),            \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),          \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),          \
  "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),          \
  "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),          \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),          \
  "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),          \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),          \
  "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),          \
  "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),          \
  "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),          \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])

// D(64x192, f32) += A(64x16, bf16, smem) * B(192x16, bf16, smem)^T
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " NOPE_ACC_REGS
      ", %96, %97, p, 1, 1, 0, 0;\n}\n"
      : NOPE_ACC_OPERANDS(d)
      : "l"(da), "l"(db), "r"(1));
}

// D(64x192, f32) = A(64x8, tf32, smem) * B(192x8, tf32, smem)^T (+ D if
// accumulate); tf32 takes K-major operands only, with no transpose immediates
__device__ __forceinline__ void wgmma_m64n192k8_tf32(float (&d)[96], uint64_t da, uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 " NOPE_ACC_REGS
      ", %96, %97, p, 1, 1;\n}\n"
      : NOPE_ACC_OPERANDS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// the 64 float32 accumulators of an m64n128 tile, as asm operands %0-%63
#define NOPE_ACC64_REGS                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                         \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                                   \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                                 \
  " %24, %25, %26, %27, %28, %29, %30, %31,"                                 \
  " %32, %33, %34, %35, %36, %37, %38, %39,"                                 \
  " %40, %41, %42, %43, %44, %45, %46, %47,"                                 \
  " %48, %49, %50, %51, %52, %53, %54, %55,"                                 \
  " %56, %57, %58, %59, %60, %61, %62, %63}"
#define NOPE_ACC64_OPERANDS(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),     \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),            \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),          \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),          \
  "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),          \
  "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),          \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),          \
  "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// D(64x128, f32) = A(64x8, tf32) * B(128x8, tf32)^T (+ D if accumulate): the
// N tile of a conv that writes no GroupNorm partials, where Cout fills it
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " NOPE_ACC64_REGS
      ", %64, %65, p, 1, 1;\n}\n"
      : NOPE_ACC64_OPERANDS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// the tf32 wgmma of an N tile of BN columns (BN / 2 accumulators a thread)
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], uint64_t da, uint64_t db, int accumulate) {
  static_assert(BN == 192 || BN == 128, "the tf32 conv's N tile is 192 or 128 columns");
  if constexpr (BN == 192)
    wgmma_m64n192k8_tf32(d, da, db, accumulate);
  else
    wgmma_m64n128k8_tf32(d, da, db, accumulate);
}

// x rounded to tf32: to nearest, ties away from zero, low 13 bits 0
__device__ __forceinline__ float tf32_hi(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xFFFFE000u);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wait for this warpgroup's wgmma groups
template <int N>
__device__ __forceinline__ void wgmma_wait(float (&d)[N]) {
  wgmma_wait_group<0>();
  // the accumulators are read only after the wait
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// `threads` threads of the block (a multiple of 32, from thread 0) meet at
// named barrier 1: the A-by-TMA conv's epilogue runs without its producer
// warpgroup, which has left
__device__ __forceinline__ void sync_threads(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// The epilogue of one (bm x BN) tile staged as float32 in shared memory
// (row pitch BN + 8, then 2 x BN floats of scratch), run by threads
// 0 .. threads - 1: add the bias, store rows m0.. of `out` (M, Cout), and,
// when `part` is given, write the tile's partial GroupNorm statistics: for
// every (sample, group) it touches, (count, mean, M2) at
// part[((mt * G + g) * segmax + s) * 3], s = sample - first sample of the tile.
template <int BN = kTileN>
__device__ void finish_tile(float* stage, int bm, int mt, int n0, int M, int Cout, int HW,
                            int G, int segmax, const void* bias, int bdt,
                            float* __restrict__ out, float* __restrict__ part, int tid,
                            int threads) {
  constexpr int kP = BN + 8;
  const int m0 = mt * bm;
  const int rows = min(bm, M - m0), cols = min(BN, Cout - n0);
  for (int i = tid; i < rows * (BN / 4); i += threads) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    if (c >= cols) continue;
    float4 v = *reinterpret_cast<float4*>(&stage[r * kP + c]);
    v.x += load_f(bias, n0 + c, bdt);
    v.y += load_f(bias, n0 + c + 1, bdt);
    v.z += load_f(bias, n0 + c + 2, bdt);
    v.w += load_f(bias, n0 + c + 3, bdt);
    *reinterpret_cast<float4*>(&stage[r * kP + c]) = v;
    *reinterpret_cast<float4*>(&out[static_cast<size_t>(m0 + r) * Cout + n0 + c]) = v;
  }
  if (part == nullptr) return;
  // per sample segment: column sums, each thread down its own column
  // (conflict-free), then per group; the mean, then the same for M2
  float* colsum = stage + bm * kP;
  float* gmean = colsum + BN;
  const int cg = Cout / G, ng = cols / cg;
  const int b0 = m0 / HW, nseg = (m0 + rows - 1) / HW - b0 + 1;
  for (int s = 0; s < nseg; ++s) {
    const int ra = max(m0, (b0 + s) * HW) - m0, rb = min(m0 + rows, (b0 + s + 1) * HW) - m0;
    const float n = static_cast<float>((rb - ra) * cg);
    sync_threads(threads);
    for (int c = tid; c < cols; c += threads) {
      float a = 0.f;
      for (int r = ra; r < rb; ++r) a += stage[r * kP + c];
      colsum[c] = a;
    }
    sync_threads(threads);
    for (int g = tid; g < ng; g += threads) {
      float a = 0.f;
      for (int c = g * cg; c < (g + 1) * cg; ++c) a += colsum[c];
      gmean[g] = a / n;
    }
    sync_threads(threads);
    for (int c = tid; c < cols; c += threads) {
      const float mu = gmean[c / cg];
      float a = 0.f;
      for (int r = ra; r < rb; ++r) {
        const float d = stage[r * kP + c] - mu;
        a += d * d;
      }
      colsum[c] = a;
    }
    sync_threads(threads);
    for (int g = tid; g < ng; g += threads) {
      float a = 0.f;
      for (int c = g * cg; c < (g + 1) * cg; ++c) a += colsum[c];
      float* o = part + ((static_cast<size_t>(mt) * G + n0 / cg + g) * segmax + s) * 3;
      o[0] = n;
      o[1] = gmean[g];
      o[2] = a;
    }
  }
}

// The bf16 conv's staged epilogue of one unsplit (bm x 192) tile, run by
// the kThreads finisher threads (a multiple of 48): thread t keeps the four
// columns 4 (t % 48) .. + 3 (inside one group: cg % 4 == 0) down the rows
// r = t / 48 (mod kThreads / 48), as norm_staged does, with float4 sums, so
// its few warps have independent work in flight.  Per segment (the tile's
// rows of one sample): pass A adds the bias in place, stores the rows to
// `out` unless it is null, and sums each column down the thread's rows;
// the group's column sums make the segment's (count, mean); pass B sums the
// squared deviations from it into M2.  The partial goes to part[((mt * G
// + g) * segmax + s) * 3] or, fused, to own[(s * kRegGroups + g) * 3]
// (shared memory); neither given, only pass A runs.  Scratch after the
// tile: kThreads / 48 x 192 column sums, then kRegGroups means.
template <int kThreads>
__device__ void finish_staged(float* stage, int bm, int mt, int n0, int M, int Cout, int HW, int G, int segmax,
                              const void* bias, int bdt, float* out, float* part, float* own, int tid) {
  constexpr int kQuads = kTileN / 4, kStep = kThreads / kQuads;
  static_assert(kThreads % kQuads == 0, "a thread a column quad");
  float4* red = reinterpret_cast<float4*>(stage + bm * kPitch);
  float* gmean = stage + bm * kPitch + kStep * kTileN;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int m0 = mt * bm, rows = min(bm, M - m0), cols = min(kTileN, Cout - n0);
  const int quad = tid % kQuads, c = 4 * quad, par = tid / kQuads, cg = Cout / G, ng = cols / cg;
  const bool live = c < cols, stats = part != nullptr || own != nullptr;
  const float4 bv = live ? make_float4(load_f(bias, n0 + c, bdt), load_f(bias, n0 + c + 1, bdt),
                                       load_f(bias, n0 + c + 2, bdt), load_f(bias, n0 + c + 3, bdt))
                         : zero;
  const int b0 = m0 / HW, nseg = (m0 + rows - 1) / HW - b0 + 1;
  for (int s = 0; s < nseg; ++s) {
    const int ra = max(m0, (b0 + s) * HW) - m0, rb = min(m0 + rows, (b0 + s + 1) * HW) - m0;
    const int first = ra + ((par - ra) % kStep + kStep) % kStep;
    const float n = static_cast<float>((rb - ra) * cg);
    float4 sum = zero;
    for (int r = live ? first : rb; r < rb; r += kStep) {  // pass A
      float4* p = reinterpret_cast<float4*>(&stage[r * kPitch + c]);
      float4 v = *p;
      v = make_float4(v.x + bv.x, v.y + bv.y, v.z + bv.z, v.w + bv.w);
      *p = v;
      if (out != nullptr) *reinterpret_cast<float4*>(&out[static_cast<size_t>(m0 + r) * Cout + n0 + c]) = v;
      sum = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
    }
    if (!stats) continue;
    red[par * kQuads + quad] = sum;
    sync_threads(kThreads);
    float* o = own != nullptr ? own + (s * kRegGroups + tid) * 3
                              : part + ((static_cast<size_t>(mt) * G + n0 / cg + tid) * segmax + s) * 3;
    if (tid < ng) {  // the group's columns, each parity in turn
      float4 a = zero;
      for (int k = tid * cg / 4; k < (tid + 1) * cg / 4; ++k)
        for (int j = 0; j < kStep; ++j) {
          const float4 v = red[j * kQuads + k];
          a = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
        }
      gmean[tid] = ((a.x + a.y) + (a.z + a.w)) / n;
      o[0] = n;
      o[1] = gmean[tid];
    }
    sync_threads(kThreads);
    const float mu = live ? gmean[c / cg] : 0.f;
    float4 sq = zero;
    for (int r = live ? first : rb; r < rb; r += kStep) {  // pass B
      const float4 v = *reinterpret_cast<const float4*>(&stage[r * kPitch + c]);
      const float4 d = make_float4(v.x - mu, v.y - mu, v.z - mu, v.w - mu);
      sq = make_float4(sq.x + d.x * d.x, sq.y + d.y * d.y, sq.z + d.z * d.z, sq.w + d.w * d.w);
    }
    red[par * kQuads + quad] = sq;
    sync_threads(kThreads);
    if (tid < ng) {
      float4 a = zero;
      for (int k = tid * cg / 4; k < (tid + 1) * cg / 4; ++k)
        for (int j = 0; j < kStep; ++j) {
          const float4 v = red[j * kQuads + k];
          a = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
        }
      o[2] = (a.x + a.y) + (a.z + a.w);
    }
    sync_threads(kThreads);  // red and gmean serve the next segment
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`; a
// wait that never ends (a phase that cannot complete) traps, so the launch
// fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++tries == (1u << 26)) __trap();
  } while (!done);
}

// arrive on `bar` and expect `bytes` more from asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// TMA: the box of `map` at (c0 inner, c1 outer) into shared memory at
// `dst`, completing `bar`'s transaction count
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// TMA: the 4-D box of `map` at (c0, c1, c2, c3), innermost first; parts
// of the box outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// TMA multicast: the 2-D box of `map` at (c0, c1) into the same offset of
// every CTA of the cluster in `mask`, completing each one's mbarrier at `bar`
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                                      uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

// arrive on the mbarrier at offset `bar` of CTA `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of the cluster that has not exited meets here
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// store {a, b, c, d} at this CTA's shared address `addr` in CTA `cta` of the
// cluster (distributed shared memory), completing 16 bytes of the
// transaction count of the mbarrier at offset `bar` there: the receiver
// arms its barrier with the bytes it expects and waits on it, as for a TMA
// load, with no fence on either side
__device__ __forceinline__ void st_async_v4(uint32_t addr, uint32_t cta, float a, float b, float c, float d,
                                            uint32_t bar) {
  asm volatile(
      "{\n.reg .b32 ra, rb;\nmapa.shared::cluster.u32 ra, %0, %1;\nmapa.shared::cluster.u32 rb, %2, %1;\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [ra], {%3, %4, %5, %6}, [rb];\n}\n" ::"r"(addr),
      "r"(cta), "r"(bar), "f"(a), "f"(b), "f"(c), "f"(d)
      : "memory");
}

// The bf16 conv's fused GroupNorm epilogue.  With dst set, a tile's biased
// sums h are normalised where they are, SiLU((h - mu) * rstd * gamma + beta)
// + emb[sample] (+ res), with gn_silu's arithmetic, and stored as bf16 rows
// of dst (M, Cout); neither the float32 h nor its partials leave the SM.
struct FusedNorm {
  const void* gamma;
  const void* beta;
  const void* emb;  // (B, Cout), or null
  const void* res;  // (M, Cout) of dtype rdt, or null
  int pdt, rdt;     // dtype codes: gamma, beta and emb; res
  __nv_bfloat16* dst;
  float eps;
};

// The normalisation tables of a tile: for each (segment s, group g) of its
// nseg samples and ng groups, Chan's merge from zero of `parts` (count,
// mean, M2) partials, in order: part p of (s, g) at
// slot[(p * kRegGroups + s * kRegGroups + g) * stride] -- the tile's own
// (one part, stride 3), or the partials of a sample's tiles that the
// cluster's CTAs stored here in rank order, which is tile order (stride 4):
// the merge of gn_finalize.  table[(s * kRegGroups + g) * 2] = (mu, rstd).
__device__ void merge_tables(const float* slot, float* table, int nseg, int ng, int parts, int stride, float eps,
                             int tid, int threads) {
  for (int k = tid; k < nseg * ng; k += threads) {
    const int i = (k / ng) * kRegGroups + k % ng;
    float n = 0.f, mu = 0.f, m2 = 0.f;
    for (int p = 0; p < parts; ++p) {
      const float* e = slot + (p * kRegGroups + i) * stride;
      chan_merge(n, mu, m2, e[0], e[1], e[2]);
    }
    table[2 * i] = mu;
    table[2 * i + 1] = norm_rstd(m2, n, eps);
  }
}

// Normalise a staged (bm x 192) tile of biased sums (as finish_staged
// leaves it) by its tables and store rows m0.. of fn.dst, as gn_silu would,
// run by finish_staged's kThreads threads on its mapping: thread t keeps
// columns 4 (t % 48) .. + 3 (one group) down every kThreads / 48-th row.
// A segment's mean, scales and emb are the thread's constants; its rows go
// in batches of kRows (loads clamped to the thread's last row, stores
// predicated), with the next batch's res loaded ahead of this batch's
// stores (a store may alias a later load for all the compiler knows).
template <int kThreads>
__device__ void norm_staged(const float* stage, const float* table, int bm, int mt, int n0, int M, int Cout,
                            int HW, int G, const FusedNorm& fn, int tid) {
  constexpr int kQuads = kTileN / 4, kStep = kThreads / kQuads, kRows = 8;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int m0 = mt * bm, b0 = m0 / HW, rows = min(bm, M - m0), c = 4 * (tid % kQuads), par = tid / kQuads;
  if (c >= min(kTileN, Cout - n0)) return;
  const int g = c / (Cout / G), nseg = (m0 + rows - 1) / HW - b0 + 1;
  const float4 ga = load4(fn.gamma, n0 + c, fn.pdt), be = load4(fn.beta, n0 + c, fn.pdt);
  for (int s = 0; s < nseg; ++s) {
    const int ra = max(m0, (b0 + s) * HW) - m0, rb = min(m0 + rows, (b0 + s + 1) * HW) - m0;
    const int first = ra + ((par - ra) % kStep + kStep) % kStep;
    if (first >= rb) continue;
    const int last = first + (rb - 1 - first) / kStep * kStep;
    const float mu = table[(s * kRegGroups + g) * 2], rs = table[(s * kRegGroups + g) * 2 + 1];
    const float4 sc = make_float4(__fmul_rn(rs, ga.x), __fmul_rn(rs, ga.y), __fmul_rn(rs, ga.z), __fmul_rn(rs, ga.w));
    const float4 em = fn.emb != nullptr ? load4(fn.emb, static_cast<size_t>(b0 + s) * Cout + n0 + c, fn.pdt) : zero;
    auto res_at = [&](int r) {
      return load4(fn.res, static_cast<size_t>(m0 + min(r, last)) * Cout + n0 + c, fn.rdt);
    };
    float4 rv[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) rv[k] = fn.res != nullptr ? res_at(first + k * kStep) : zero;
    for (int r = first; r < rb; r += kRows * kStep) {
      float4 v[kRows], rcur[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        v[k] = *reinterpret_cast<const float4*>(&stage[min(r + k * kStep, last) * kPitch + c]);
        rcur[k] = rv[k];
        if (fn.res != nullptr) rv[k] = res_at(r + (kRows + k) * kStep);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        float4 y = make_float4(gn_act(v[k].x, mu, sc.x, be.x, em.x), gn_act(v[k].y, mu, sc.y, be.y, em.y),
                               gn_act(v[k].z, mu, sc.z, be.z, em.z), gn_act(v[k].w, mu, sc.w, be.w, em.w));
        if (fn.res != nullptr)
          y = make_float4(__fadd_rn(y.x, rcur[k].x), __fadd_rn(y.y, rcur[k].y), __fadd_rn(y.z, rcur[k].z),
                          __fadd_rn(y.w, rcur[k].w));
        if (r + k * kStep < rb) store4(fn.dst, static_cast<size_t>(m0 + r + k * kStep) * Cout + n0 + c, DT_BF16, y);
      }
    }
  }
}

// The float32 conv in 3xTF32:
// out[m, co] = bias[co] + sum_{tap, ci} x[pixel(m) + shift(tap), ci] * w[co, tap, ci]
// x: (B, H, W, Cin) NHWC float32, Cin % 32 == 0; w: (2, Cout, ks*ks*Cin),
// the hi plane, then the lo plane, read through the TMA maps `wmap` and
// `wmap_lo`, boxes of BN rows x one K-slice, swizzled.  Block (mt, nt,
// split) takes K-slices [kt0, kt1) of tile (mt, nt) with BM/64
// warpgroups, which all multiply and all gather the A tiles (cp.async);
// one thread asks the TMA for each B tile.  A ring of STAGES slots runs
// ahead of the tensor cores.  With one split the block finishes the tile;
// with more it stores its raw sums to ws[split] for splitk_reduce.  The N
// tile is 192 columns (whole GroupNorm groups: every launch that writes
// partials) or 128 (a launch without partials whose Cout fills it).  (bf16
// runs conv_wgmma_tma_kernel, below.)
template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(BM * 2, 1)
conv_wgmma_kernel(const float* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap wmap_lo, const void* __restrict__ bias,
                  int bdt, float* __restrict__ out, float* __restrict__ part,
                  float* __restrict__ ws, int B, int H, int W, int Cin, int Cout, int ks, int G,
                  int segmax, int splits) {
  constexpr int kSlice = Operand<float>::kSlice, kChunk = 4;  // floats per 16-byte chunk
  constexpr int kThreads = BM * 2, kRowStep = kThreads / 8, kAcc = BN / 2, kP = BN + 8;
  // a stage: A hi, A lo, B hi, B lo
  constexpr int kABytes = BM * kRowBytes, kBBytes = BN * kRowBytes;
  constexpr int kStageBytes = 2 * (kABytes + kBBytes);
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles sit on 1024-byte boundaries (the swizzle's period)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (ring - raw);
  __shared__ __align__(8) uint64_t full[STAGES];  // a slot's B tile has landed
  const uint32_t bar = smem_u32(full);

  const int tid = threadIdx.x, wg = tid >> 7, chunk = tid & 7;
  const int M = B * H * W, pad = ks / 2;
  const int mt = blockIdx.x, m0 = mt * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int per_tap = Cin / kSlice, KT = ks * ks * per_tap;
  const int kt0 = static_cast<int>(static_cast<long long>(split) * KT / splits);
  const int kt1 = static_cast<int>(static_cast<long long>(split + 1) * KT / splits);

  // this thread's four A rows: output pixel, and its (y, x) for the halo test
  int am[4], ay[4], ax[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid >> 3) + i * kRowStep;
    am[i] = m;
    const int r = m % (H * W);
    ay[i] = m < M ? r / W : -(1 << 28);
    ax[i] = r % W;
  }

  auto load_stage = [&](int slot, int kt) {
    const int tap = kt / per_tap, c0 = (kt - tap * per_tap) * kSlice + chunk * kChunk;
    const int dy = tap / ks - pad, dx = tap % ks - pad;
    const uint32_t sa = ring + slot * kStageBytes, sb = sa + 2 * kABytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + i * kRowStep;
      const int yy = ay[i] + dy, xx = ax[i] + dx;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const float* src = ok ? x + static_cast<size_t>(am[i] + dy * W + dx) * Cin + c0 : x;
      cp_async_16(sa + r * kRowBytes + ((chunk ^ (r & 7)) << 4), src, ok);
    }
    if (tid == 0) {  // rows past Cout arrive as zeros
      mbar_expect_tx(bar + 8 * slot, 2 * kBBytes);
      tma_load_2d(sb, &wmap, kt * kSlice, n0, bar + 8 * slot);
      tma_load_2d(sb + kBBytes, &wmap_lo, kt * kSlice, n0, bar + 8 * slot);
    }
  };

  // this thread's own A chunks of `slot`, once they have landed, become hi
  // in place and lo = x - hi at the same offset of the lo slot
  auto split_stage = [&](int slot) {
    uint8_t* sa = smem + slot * kStageBytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + i * kRowStep;
      float4* hi = reinterpret_cast<float4*>(sa + r * kRowBytes + ((chunk ^ (r & 7)) << 4));
      const float4 v = *hi;
      const float4 h = make_float4(tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z), tf32_hi(v.w));
      *hi = h;
      *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(hi) + kABytes) =
          make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
    }
  };

  if (tid == 0)
    for (int s = 0; s < STAGES; ++s) mbar_init(bar + 8 * s, 1);
  __syncthreads();

  // each K-slice's products go into acc from zero, and acc into `total`
  // with round-to-nearest adds.  The tensor cores' accumulation truncates:
  // across a 20,736-deep K it drifted ~1e-4 of the output.
  float acc[kAcc], total[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = total[i] = 0.f;

  // loads run kAhead K-slices ahead of the tensor cores
  constexpr int kAhead = STAGES - 1;
  static_assert(kAhead >= 1, "the ring is too short");
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (kt0 + s < kt1) load_stage(s, kt0 + s);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0, slot = i % STAGES;
    cp_async_wait<kAhead - 1>();
    split_stage(slot);
    // this thread's copies and splits of `slot` are done; make them
    // visible to the tensor cores (async proxy), then wait for every thread's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    mbar_wait(bar + 8 * slot, (i / STAGES) & 1);
    const uint32_t sa = ring + slot * kStageBytes + wg * 64 * kRowBytes;
    const uint32_t sb = ring + slot * kStageBytes + 2 * kABytes;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // 32 bytes of every row a step; small terms first: lo*hi, hi*lo, hi*hi
      wgmma_tf32<BN>(acc, smem_desc(sa + kABytes + 32 * k), smem_desc(sb + 32 * k), k > 0);
      wgmma_tf32<BN>(acc, smem_desc(sa + 32 * k), smem_desc(sb + kBBytes + 32 * k), 1);
      wgmma_tf32<BN>(acc, smem_desc(sa + 32 * k), smem_desc(sb + 32 * k), 1);
    }
    wgmma_commit();
    // refill the slot of K-slice i - 1: every warpgroup waited for that
    // slice's wgmma before the barrier above
    if (kt + kAhead < kt1) load_stage((i + kAhead) % STAGES, kt + kAhead);
    cp_async_commit();
    wgmma_wait(acc);
#pragma unroll
    for (int j = 0; j < kAcc; ++j) total[j] += acc[j];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the staged tile

  // accumulator layout of m64nNkK: thread (warp, lane) of a warpgroup holds
  // rows 16 warp + lane/4 (+8), columns 8 j + 2 (lane % 4) (+1)
  float* stage = reinterpret_cast<float*>(smem);
  const int lane = tid & 31, r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(&stage[r0 * kP + c]) = make_float2(total[4 * j], total[4 * j + 1]);
    *reinterpret_cast<float2*>(&stage[(r0 + 8) * kP + c]) = make_float2(total[4 * j + 2], total[4 * j + 3]);
  }
  __syncthreads();
  if (splits == 1) {
    finish_tile<BN>(stage, BM, mt, n0, M, Cout, H * W, G, segmax, bias, bdt, out, part, tid, kThreads);
    return;
  }
  float* dst = ws + static_cast<size_t>(split) * M * Cout;
  const int rows = min(BM, M - m0), cols = min(BN, Cout - n0);
  for (int i = tid; i < rows * (BN / 4); i += kThreads) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    if (c < cols)
      *reinterpret_cast<float4*>(&dst[static_cast<size_t>(m0 + r) * Cout + n0 + c]) =
          *reinterpret_cast<const float4*>(&stage[r * kP + c]);
  }
}

// The register epilogue of one bf16 conv tile (no staging): + bias,
// float32 stores (or, with more than one split, the raw sums to ws[split]),
// and the tile's GroupNorm partials as finish_tile writes them.  The tile
// holds whole rows of one sample or whole samples (segment s = its s-th
// sample).  Per row, each 8-column block's sum (a quad's four lanes) goes
// to `rowsum`; a warp per (segment, group) sums them in a fixed order (its
// lanes down the rows, then a shuffle tree): the mean into `gmean`, then
// the same for the squared deviations from it.  Run by the `threads`
// consumer threads, which meet at named barrier 1.  Only for groups that
// register_groups takes: each a whole number of 8-column blocks, at most
// kRegGroups of them in the N tile (gmean holds kRegGroups a segment).
__device__ __forceinline__ void finish_registers(float (&acc)[96], int threads, int tid, int r0, int mt,
                                                 int split, int m0, int n0, int M, int HW, int Cout,
                                                 int G, int bm, int segmax, int splits,
                                                 const void* bias, int bdt, float* out, float* part,
                                                 float* ws, float* rowsum, float* gmean) {
  constexpr int kQ = kTileN / 8, kRowSums = kQ + 1;  // padded: lanes on consecutive rows, other banks
  const int lane = tid & 31, quad = lane & 3;
  const int rows = min(bm, M - m0), cols = min(kTileN, Cout - n0);
  float* dst = splits > 1 ? ws + static_cast<size_t>(split) * M * Cout : out;
  if (splits == 1) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int c = 8 * q + 2 * quad;
      const float b0 = c < cols ? load_f(bias, n0 + c, bdt) : 0.f;
      const float b1 = c < cols ? load_f(bias, n0 + c + 1, bdt) : 0.f;
      acc[4 * q] += b0;
      acc[4 * q + 1] += b1;
      acc[4 * q + 2] += b0;
      acc[4 * q + 3] += b1;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int c = 8 * q + 2 * quad;
      if (c < cols)
        *reinterpret_cast<float2*>(&dst[static_cast<size_t>(m0 + r) * Cout + n0 + c]) =
            make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
    }
  }
  if (splits > 1 || part == nullptr) return;
  const int cg = Cout / G, qg = cg / 8;  // a group's 8-column blocks (register_groups)
  const int b0 = m0 / HW, nseg = (m0 + rows - 1) / HW - b0 + 1, ng = cols / cg;
  int seg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) seg[h] = (m0 + r0 + 8 * h) / HW - b0;
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        float v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
        if (pass == 1 && seg[h] < nseg && q / qg < ng) {
          const float mu = gmean[seg[h] * kRegGroups + q / qg];
          v0 = (v0 - mu) * (v0 - mu);
          v1 = (v1 - mu) * (v1 - mu);
        }
        float sum = v0 + v1;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (quad == 0) rowsum[(r0 + 8 * h) * kRowSums + q] = sum;
      }
    }
    sync_threads(threads);
    for (int i = tid >> 5; i < nseg * ng; i += threads / 32) {
      const int sgm = i / ng, g = i % ng;
      const int ra = max(m0, (b0 + sgm) * HW) - m0, rb = min(m0 + rows, (b0 + sgm + 1) * HW) - m0;
      float a = 0.f;
      for (int r = ra + lane; r < rb; r += 32)
        for (int q = g * qg; q < (g + 1) * qg; ++q) a += rowsum[r * kRowSums + q];
      a = warp_sum(a);
      const float n = static_cast<float>((rb - ra) * cg);
      if (lane != 0) continue;
      if (pass == 0) {
        gmean[sgm * kRegGroups + g] = a / n;
      } else {
        float* o = part + ((static_cast<size_t>(mt) * G + n0 / cg + g) * segmax + sgm) * 3;
        o[0] = n;
        o[1] = gmean[sgm * kRegGroups + g];
        o[2] = a;
      }
    }
    sync_threads(threads);
  }
}

// Whether finish_registers takes the GroupNorm groups of cg = Cout / G
// channels: whole 8-column blocks, at most kRegGroups groups in an N tile.
// Other groups (e.g. 32 groups of 256 channels, 24 in the first N tile)
// take the staged epilogue, whose finish_staged takes any cg | 192.  The
// fused epilogue takes only these groups.
__host__ __device__ constexpr bool register_groups(int Cout, int G) {
  return Cout % G == 0 && (Cout / G) % 8 == 0 && (Cout < kTileN ? Cout : kTileN) / (Cout / G) <= kRegGroups;
}

// The A-by-TMA conv's shared memory after its ring, in floats: the staged
// tile and finish_staged's scratch, with the fused epilogue's own partials (3
// floats a (segment, group)), its two exchange slots (kMaxCluster x
// kRegGroups entries of 4 floats) and its tables (2 a (segment, group));
// or finish_registers' row sums and the means of kRegGroups groups of
// `segmax` samples
__host__ __device__ constexpr int after_ring_floats(int bm, bool staged, int segmax, bool fused) {
  return staged ? bm * kPitch + 2 * kTileN + kRegGroups +
                      (fused ? 5 * kRegGroups * segmax + 8 * kMaxCluster * kRegGroups : 0)
                : bm * (kTileN / 8 + 1) + kRegGroups * segmax;
}

// its ring's depth in K-slices: the deepest that fits beside that (segmax
// up to kFuseSegs staged and fused, the tile's rows from registers) and its
// barriers, at most NOPE_CONV_RING: 5 for 64-row tiles and for 128 from
// registers, 3 beside a staged 128-row tile
template <int CONS, bool STAGED>
__host__ __device__ constexpr int conv_ring() {
  constexpr int kBM = 64 * CONS, kStageBytes = (kBM + kTileN) * kRowBytes;
  constexpr int kFits = (kSmemMax - 1024 - 4 * after_ring_floats(kBM, STAGED, STAGED ? kFuseSegs : kBM, STAGED) -
                         8 * (2 * NOPE_CONV_RING + 4)) / kStageBytes;
  return kFits < NOPE_CONV_RING ? kFits : NOPE_CONV_RING;
}

// The bf16 conv with A by TMA, a persistent grid of clusters of `cl` CTAs
// along M (cl = 1: plain blocks).  A unit is `cl` neighbouring M tiles
// (cl p .. cl p + cl - 1, CTA rank r taking cl p + r) of one (nt, split);
// cluster i takes units i, i + gridDim.x / cl, ..., mt fastest.  A tile is
// output pixels [mt * bm, mt * bm + bm), a box of `rows` whole image rows
// of `samples` samples (bm <= BM = 64 * CONS), by 192 columns, over
// K-slices [kt0, kt1) of its split.  Warpgroups 0 .. CONS - 1 multiply,
// one m64n192 product each.  In warpgroup CONS, one thread of warp 0 is
// the producer: it asks the TMA for each K-slice's A box (x at the slice's
// tap shift: the image's padding arrives as the box's zero fill) and B
// tile, into a ring of kRing slots (conv_ring), each with a `full` and an
// `empty` mbarrier, across tiles.  A consumer waits on `full`, issues the
// slice's wgmmas, commits, and waits until only that group is in flight
// (wait_group 1) before it releases the previous slice's slot on `empty`:
// the tensor cores do not drain between slices, and no block-wide barrier
// stands in the mainloop.  With `mcast` the cluster's CTAs pair up (2 p,
// 2 p + 1): each asks for half the weight tile and multicasts it to both,
// so a pair reads each weight slice from L2 once, and a slot is free only
// when both CTAs' consumers have released it (their arrivals meet on each
// CTA's `empty`).  (Sharing it across a cluster of 8 kept all 8 mainloops
// in lockstep and was slower: PERF.md.)  A unit's tile past the last M
// tile is a ghost: it loads zeros and skips its epilogue.  Two epilogues:
// - STAGED (tiles of few K-slices, whose epilogue would rival their
//   mainloop): the consumers stage their sums in shared memory
//   (`staged_full`) and go on to the next tile; warps 1-3 of warpgroup
//   CONS finish the staged tile meanwhile (finish_staged, or finish_tile
//   for groups narrower than its 4-column quads; or, with more than one
//   split, the raw sums to ws[split] for splitk_reduce) and free it
//   (`staged_empty`).  The staged tile leaves room for a ring of 3 slots
//   at 128 rows.  Any groups cg | 192.
// - otherwise the consumers finish the tile from their registers
//   (finish_registers, for the groups register_groups takes), which
//   leaves room for a ring of 5.
// Fused (fn.dst set, one split, STAGED): GroupNorm, SiLU and emb or res in
// the finishers' epilogue, bf16 out (FusedNorm), beside the next tile's
// mainloop.  A tile of whole samples normalises alone.  Otherwise the
// unit's cl tiles are the sample's (cl bm = HW): the finishers push the
// tile's partials (st.async) into entry `rank` of a slot in every CTA of
// the cluster, completing bytes of that CTA's `xfull`, which each CTA arms
// with the bytes it expects; they wait on their own and merge the cl
// partials, now local, in rank order (merge_tables) before they normalise
// the tile (norm_staged).  Slots and barriers go by unit parity: a CTA
// pushes unit i + 2 only after every peer's unit i + 1 has arrived, which
// each peer pushes after merging unit i, so no slot is overwritten before
// it is read.  No barrier.cluster stands in the loop: the producer and
// the finishers walk their own loops.
template <int CONS, bool STAGED>
__global__ void __launch_bounds__(128 * (CONS + 1), 1)
conv_wgmma_tma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                      const void* __restrict__ bias, int bdt, float* __restrict__ out,
                      float* __restrict__ part, float* __restrict__ ws, int M, int HW, int W, int Cout,
                      int ks, int per_tap, int G, int bm, int segmax, int splits, int cl, int mcast,
                      const FusedNorm fn) {
  constexpr int kSlice = Operand<__nv_bfloat16>::kSlice, kRing = conv_ring<CONS, STAGED>();
  static_assert(kRing >= 2, "the ring is too short");
  constexpr int kBM = 64 * CONS, kConsumers = 128 * CONS, kFinishers = 96;
  constexpr int kABytes = kBM * kRowBytes, kStageBytes = kABytes + kTileN * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles sit on 1024-byte boundaries (the swizzle's period); the
  // staged tile, or finish_registers' sums, follow the ring
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  float* after_ring = reinterpret_cast<float*>(smem_raw + (ring - raw) + kRing * kStageBytes);
  __shared__ __align__(8) uint64_t full_bars[kRing], empty_bars[kRing], staged_bars[2], xfull_bars[2];
  const uint32_t full = smem_u32(full_bars), empty = smem_u32(empty_bars), xfull = smem_u32(xfull_bars);
  const uint32_t staged_full = smem_u32(staged_bars), staged_empty = staged_full + 8;
  const bool fuse = fn.dst != nullptr, xchg = fuse && bm < HW;
  // the CTAs that fill (and free) each ring slot: this CTA, or with mcast
  // the pair (2 p, 2 p + 1) of the cluster it belongs to
  const int sharers = mcast ? 2 : 1;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int tiles_m = (M + bm - 1) / bm, tiles_n = (Cout + kTileN - 1) / kTileN;
  const int units_m = (tiles_m + cl - 1) / cl, rank = cl > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int n_units = units_m * tiles_n * splits, KT = ks * ks * per_tap;
  const int first = blockIdx.x / cl, stride = gridDim.x / cl;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);                    // the producer's expect_tx
      mbar_init(empty + 8 * s, 4 * CONS * sharers);  // one arrive per consumer warp of the sharers
    }
    mbar_init(staged_full, 4 * CONS);
    mbar_init(staged_empty, 1);
    mbar_init(xfull, 1);  // the finishers' expect_tx, then the cluster's st.async bytes; by unit parity
    mbar_init(xfull + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (cl > 1)
    cluster_sync();  // the peers' barriers exist before any multicast or remote arrive
  else
    __syncthreads();

  if (wg == CONS) {
    const int warp = (tid >> 5) & 3;
    if (warp == 0) {  // the producer
      if (lane != 0) return;
      const int pad = ks / 2, share = kTileN / sharers, peer0 = rank - rank % sharers;
      const uint32_t bytes = bm * kRowBytes + kTileN * kRowBytes;  // out-of-bounds zeros count
      int slot = 0, phase = 0, issued = 0;
      for (int u = first; u < n_units; u += stride) {
        const int mt = (u % units_m) * cl + rank, nt = (u / units_m) % tiles_n, split = u / (units_m * tiles_n);
        const int m0 = mt * bm, b0 = m0 / HW, y0 = (m0 - b0 * HW) / W;
        const int kt0 = static_cast<int>(static_cast<long long>(split) * KT / splits);
        const int kt1 = static_cast<int>(static_cast<long long>(split + 1) * KT / splits);
        for (int kt = kt0; kt < kt1; ++kt, ++issued) {
          if (issued >= kRing) mbar_wait(empty + 8 * slot, phase ^ 1);  // its last readers are done
          const int tap = kt / per_tap, c = (kt - tap * per_tap) * kSlice;
          const int dy = tap / ks - pad, dx = tap % ks - pad;
          const uint32_t sa = ring + slot * kStageBytes, bar = full + 8 * slot;
          mbar_expect_tx(bar, bytes);
          tma_load_4d(sa, &xmap, c, dx, y0 + dy, b0, bar);
          if (mcast)  // this CTA's half of the weight tile, to both CTAs of its pair
            tma_load_2d_multicast(sa + kABytes + (rank - peer0) * share * kRowBytes, &wmap, kt * kSlice,
                                  nt * kTileN + (rank - peer0) * share, bar, static_cast<uint16_t>(3 << peer0));
          else
            tma_load_2d(sa + kABytes, &wmap, kt * kSlice, nt * kTileN, bar);  // rows past Cout: zeros
          if (++slot == kRing) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
      if (cl > 1) cluster_sync();  // a peer may still multicast into this CTA
      return;
    }
    if constexpr (STAGED) {  // the finishers: warps 1-3, named barrier 1 among themselves
      const int ftid = tid - kConsumers - 32;
      // after_ring_floats: the tile's own partials, the exchange slots (two,
      // by unit parity, of kMaxCluster x kRegGroups entries of 4 floats),
      // the tables
      float* own = after_ring + kBM * kPitch + 2 * kTileN + kRegGroups;
      float* slots = own + kRegGroups * segmax * 3;
      float* table = slots + 2 * kMaxCluster * kRegGroups * 4;
      int i = 0;
      for (int u = first; u < n_units; u += stride, ++i) {
        const int mt = (u % units_m) * cl + rank, nt = (u / units_m) % tiles_n, split = u / (units_m * tiles_n);
        const int m0 = mt * bm, n0 = nt * kTileN;
        mbar_wait(staged_full, i & 1);
        if (m0 >= M) {  // a ghost tile
        } else if (fuse) {
          const int ng = min(kTileN, Cout - n0) / (Cout / G), rows = min(bm, M - m0);
          finish_staged<kFinishers>(after_ring, bm, mt, n0, M, Cout, HW, G, segmax, bias, bdt, nullptr, nullptr, own,
                                    ftid);  // ends at a barrier: the tile's partials are in `own`
          if (xchg) {  // one segment: push its ng partials to slot `rank` of every CTA of the cluster
            const uint32_t bar = xfull + 8 * (i & 1);
            float* slot = slots + (i & 1) * kMaxCluster * kRegGroups * 4;
            if (ftid == 0) mbar_expect_tx(bar, cl * ng * 16);
            for (int k = ftid; k < cl * ng; k += kFinishers) {
              const int g = k % ng;
              st_async_v4(smem_u32(slot + (rank * kRegGroups + g) * 4), k / ng, own[3 * g], own[3 * g + 1],
                          own[3 * g + 2], 0.f, bar);
            }
            mbar_wait(bar, (i >> 1) & 1);  // every tile of the sample has pushed its partials here
            merge_tables(slot, table, 1, ng, cl, 4, fn.eps, ftid, kFinishers);
          } else {
            merge_tables(own, table, (m0 + rows - 1) / HW - m0 / HW + 1, ng, 1, 3, fn.eps, ftid, kFinishers);
          }
          sync_threads(kFinishers);
          norm_staged<kFinishers>(after_ring, table, bm, mt, n0, M, Cout, HW, G, fn, ftid);
        } else if (splits == 1 && (Cout / G) % 4 == 0) {
          finish_staged<kFinishers>(after_ring, bm, mt, n0, M, Cout, HW, G, segmax, bias, bdt, out, part, nullptr,
                                    ftid);
        } else if (splits == 1) {  // groups narrower than finish_staged's 4-column quads
          finish_tile(after_ring, bm, mt, n0, M, Cout, HW, G, segmax, bias, bdt, out, part, ftid, kFinishers);
        } else {
          float* dst = ws + static_cast<size_t>(split) * M * Cout;
          const int rows = min(bm, M - m0), cols = min(kTileN, Cout - n0);
          for (int e = ftid; e < rows * (kTileN / 4); e += kFinishers) {
            const int r = e / (kTileN / 4), c = 4 * (e % (kTileN / 4));
            if (c < cols)
              *reinterpret_cast<float4*>(&dst[static_cast<size_t>(m0 + r) * Cout + n0 + c]) =
                  *reinterpret_cast<const float4*>(&after_ring[r * kPitch + c]);
          }
        }
        sync_threads(kFinishers);  // every finisher is done with the staged tile
        if (ftid == 0) mbar_arrive(staged_empty);
      }
    }
    if (cl > 1) cluster_sync();
    return;
  }

  // accumulator layout of m64nNkK: thread (warp, lane) of a warpgroup holds
  // rows 16 warp + lane/4 (+8), columns 8 q + 2 (lane % 4) (+1)
  const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const uint32_t a_rows = wg * 64 * kRowBytes;
  int slot = 0, phase = 0, i = 0;
  float acc[96];
  auto release = [&](int s) {  // in every CTA that shares the slot
    if (mcast) {
      mbar_arrive_cluster(empty + 8 * s, rank & ~1);
      mbar_arrive_cluster(empty + 8 * s, rank | 1);
    } else {
      mbar_arrive(empty + 8 * s);
    }
  };
  for (int u = first; u < n_units; u += stride, ++i) {
    const int mt = (u % units_m) * cl + rank, nt = (u / units_m) % tiles_n, split = u / (units_m * tiles_n);
    const int kt0 = static_cast<int>(static_cast<long long>(split) * KT / splits);
    const int kt1 = static_cast<int>(static_cast<long long>(split + 1) * KT / splits);
#pragma unroll
    for (int j = 0; j < 96; ++j) acc[j] = 0.f;
    int prev = -1;
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(full + 8 * slot, phase);
      const uint32_t sa = ring + slot * kStageBytes + a_rows, sb = ring + slot * kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)  // 32 bytes of every row a step
        wgmma_m64n192k16(acc, smem_desc(sa + 32 * k), smem_desc(sb + 32 * k));
      wgmma_commit();
      wgmma_wait_group<1>();  // the previous slice's products are done: free its slot
      if (prev >= 0 && lane == 0) release(prev);
      prev = slot;
      if (++slot == kRing) {
        slot = 0;
        phase ^= 1;
      }
    }
    wgmma_wait(acc);
    if (prev >= 0 && lane == 0) release(prev);
    if constexpr (STAGED) {
      if (i > 0) mbar_wait(staged_empty, (i - 1) & 1);  // the finishers are done with the last tile
#pragma unroll
      for (int q = 0; q < kTileN / 8; ++q) {
        const int c = 8 * q + 2 * (lane & 3);
        *reinterpret_cast<float2*>(&after_ring[r0 * kPitch + c]) = make_float2(acc[4 * q], acc[4 * q + 1]);
        *reinterpret_cast<float2*>(&after_ring[(r0 + 8) * kPitch + c]) =
            make_float2(acc[4 * q + 2], acc[4 * q + 3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(staged_full);
    } else if (mt * bm < M) {  // not a ghost tile
      finish_registers(acc, kConsumers, tid, r0, mt, split, mt * bm, nt * kTileN, M, HW, Cout, G, bm, segmax,
                       splits, bias, bdt, out, part, ws, after_ring,
                       after_ring + kBM * (kTileN / 8 + 1));  // after_ring_floats
    }
  }
  if (cl > 1) cluster_sync();  // the peers' consumers may still arrive on this CTA
}

// Sum the splits of one (bm x BN) tile in split order, then finish it.
template <int BN>
__global__ void __launch_bounds__(kEpiThreads)
splitk_reduce_kernel(const float* __restrict__ ws, int splits, const void* __restrict__ bias,
                     int bdt, float* __restrict__ out, float* __restrict__ part, int M,
                     int Cout, int HW, int G, int bm, int segmax) {
  extern __shared__ float stage_f[];
  const int mt = blockIdx.x, m0 = mt * bm, n0 = blockIdx.y * BN;
  const int rows = min(bm, M - m0), cols = min(BN, Cout - n0);
  for (int i = threadIdx.x; i < rows * (BN / 4); i += kEpiThreads) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    if (c >= cols) continue;
    const float* src = ws + static_cast<size_t>(m0 + r) * Cout + n0 + c;
    const size_t stride = static_cast<size_t>(M) * Cout;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += 4) {
      float4 v[4];  // four loads in flight, summed in split order
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (s0 + k < splits) v[k] = *reinterpret_cast<const float4*>(src + (s0 + k) * stride);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (s0 + k < splits) a = make_float4(a.x + v[k].x, a.y + v[k].y, a.z + v[k].z, a.w + v[k].w);
    }
    *reinterpret_cast<float4*>(&stage_f[r * (BN + 8) + c]) = a;
  }
  __syncthreads();
  finish_tile<BN>(stage_f, bm, mt, n0, M, Cout, HW, G, segmax, bias, bdt, out, part, threadIdx.x,
              kEpiThreads);
}

// One warp per (sample, group): its lanes load up to 32 of the tiles'
// partials at once, every lane merges them in tile order with Chan's
// formula (the same values in the same order, so all lanes agree), then
// the lanes write the per-channel tables of gn_silu.
__global__ void __launch_bounds__(128)
gn_finalize_kernel(const float* __restrict__ part, const void* __restrict__ gamma, int pdt,
                   float* __restrict__ mean, float* __restrict__ scale, int B, int HW, int C,
                   int G, int bm, int segmax, float eps) {
  const int i = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (i >= B * G) return;
  const int b = i / G, g = i % G;
  const int mt0 = b * HW / bm, mt1 = ((b + 1) * HW - 1) / bm;
  float n = 0.f, mu = 0.f, m2 = 0.f;
  for (int base = mt0; base <= mt1; base += 32) {
    const int mt = base + lane;
    float pn = 0.f, pm = 0.f, pq = 0.f;
    if (mt <= mt1) {
      const float* p = part + ((static_cast<size_t>(mt) * G + g) * segmax + b - mt * bm / HW) * 3;
      pn = p[0];
      pm = p[1];
      pq = p[2];
    }
    for (int t = 0; t < min(32, mt1 - base + 1); ++t) {
      const float nb = __shfl_sync(0xffffffffu, pn, t), mb = __shfl_sync(0xffffffffu, pm, t);
      chan_merge(n, mu, m2, nb, mb, __shfl_sync(0xffffffffu, pq, t));
    }
  }
  write_norm_tables(mean, scale, gamma, pdt, b, g, C, C / G, mu, norm_rstd(m2, n, eps), lane, 32);
}

template <int BM, int BN, int STAGES>
cudaError_t launch_conv_wgmma(dim3 grid, cudaStream_t stream, const float* x, const CUtensorMap& w,
                              const CUtensorMap& w_lo, const void* bias, int bdt, float* out,
                              float* part, float* ws, int B, int H, int W, int Cin, int Cout,
                              int ks, int G, int segmax, int splits) {
  constexpr int kRing = STAGES * 2 * (BM + BN) * kRowBytes;
  constexpr int kSmem = kRing + 1024;
  static_assert((BM * (BN + 8) + 2 * BN) * 4 <= kRing, "the staged tile exceeds the ring");
  static_assert(kSmem + 8 * STAGES <= kSmemMax, "the ring exceeds a block's shared memory");
  auto kernel = conv_wgmma_kernel<BM, BN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BM * 2, kSmem, stream>>>(x, w, w_lo, bias, bdt, out, part, ws, B, H, W, Cin, Cout, ks, G,
                                          segmax, splits);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A TMA map of a `rank`-D tensor (dims innermost first, byte strides of
// the outer dims), boxes of `box`, 128-byte swizzle as the wgmma
// descriptors read; out-of-bounds elements arrive as zeros.  The CUDA driver's
// encoder is looked up once (no -lcuda).
cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The TMA map of a packed weight plane (Cout, K) of T: boxes of `rows`
// rows (the N tile, or half of it) x one K-slice (128 bytes).
template <typename T>
cudaError_t weight_map(CUtensorMap* map, const void* w, int K, int Cout, int rows = kTileN) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(Cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(T)};
  const cuuint32_t box[2] = {Operand<T>::kSlice, static_cast<cuuint32_t>(rows)};
  return encode_map(map, Operand<T>::kMapType, 2, w, dims, strides, box);
}

// The TMA map of a bf16 activation (B, H, W, Cin) as a 4-D tensor (Cin, W,
// H, B): boxes of one K-slice (64 channels, 128 bytes) of W x rows x
// samples pixels, a tile's A rows in pixel order.
cudaError_t activation_map(CUtensorMap* map, const void* x, int B, int H, int W, int Cin, int rows,
                           int samples) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(Cin) * sizeof(__nv_bfloat16);
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Operand<__nv_bfloat16>::kSlice),
                             static_cast<cuuint32_t>(W), static_cast<cuuint32_t>(rows),
                             static_cast<cuuint32_t>(samples)};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims, strides, box);
}

// Sum a split conv's ws into out (and its tiles' partials) in split order,
// tiles of BN columns.
template <int BN = kTileN>
cudaError_t reduce_splits(dim3 tiles, cudaStream_t s, const float* ws, int splits, const void* bias,
                          int bdt, float* out, float* part, int M, int Cout, int HW, int G, int bm,
                          int segmax) {
  const int smem = (bm * (BN + 8) + 2 * BN) * 4;
  cudaError_t err =
      cudaFuncSetAttribute(splitk_reduce_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  splitk_reduce_kernel<BN><<<tiles, kEpiThreads, smem, s>>>(ws, splits, bias, bdt, out, part, M, Cout, HW,
                                                        G, bm, segmax);
  return cudaGetLastError();
}

// The float32 tensor-core conv in 3xTF32 (Cin % 32 == 0, Cout % 8 == 0,
// cg | 192): bm in {64, 128} rows by bn in {192, 128} columns a tile (128
// only without partials); with splits > 1, ws holds splits * M * Cout
// floats.  part (may be null) receives the tiles' GroupNorm partials,
// (ceil(M / bm), G, segmax, 3) floats.  Tiles and rings, one block an SM
// either way: 192 columns by 128 rows (2 x 80 KB) or 64 (3 x 64 KB), a
// thread holding 96 accumulators and their 96 running totals, which
// 192-row blocks' 384 threads have no registers for; 128 columns by 128
// rows (3 x 64 KB) or 64 (4 x 48 KB), a thread holding 64 accumulators
// and their 64 running totals.
int conv_tf32x3(const void* x, const void* w, const void* bias, int bdt, float* out, float* part,
                float* ws, int B, int H, int W, int Cin, int Cout, int ks, int G, int bm, int bn,
                int splits, int segmax, cudaStream_t s) {
  const int M = B * H * W, K = ks * ks * Cin;
  if (Cin % Operand<float>::kSlice || Cout % 8 || (part != nullptr && (bn != kTileN || kTileN % (Cout / G))) ||
      (bn != kTileN && bn != 128) || splits < 1 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + bm - 1) / bm, (Cout + bn - 1) / bn, splits);
  CUtensorMap wmap, wmap_lo;  // the lo plane follows the hi plane
  cudaError_t err = weight_map<float>(&wmap, w, K, Cout, bn);
  if (err == cudaSuccess)
    err = weight_map<float>(&wmap_lo, static_cast<const float*>(w) + static_cast<size_t>(Cout) * K, K, Cout, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xf = static_cast<const float*>(x);
  if (bn == kTileN && bm == 128)
    err = launch_conv_wgmma<128, kTileN, 2>(grid, s, xf, wmap, wmap_lo, bias, bdt, out, part, ws, B, H, W, Cin,
                                            Cout, ks, G, segmax, splits);
  else if (bn == kTileN && bm == 64)
    err = launch_conv_wgmma<64, kTileN, 3>(grid, s, xf, wmap, wmap_lo, bias, bdt, out, part, ws, B, H, W, Cin,
                                           Cout, ks, G, segmax, splits);
  else if (bm == 128)
    err = launch_conv_wgmma<128, 128, 3>(grid, s, xf, wmap, wmap_lo, bias, bdt, out, part, ws, B, H, W, Cin, Cout,
                                         ks, G, segmax, splits);
  else if (bm == 64)
    err = launch_conv_wgmma<64, 128, 4>(grid, s, xf, wmap, wmap_lo, bias, bdt, out, part, ws, B, H, W, Cin, Cout,
                                        ks, G, segmax, splits);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const dim3 tiles(grid.x, grid.y);
  return static_cast<int>(bn == kTileN ? reduce_splits(tiles, s, ws, splits, bias, bdt, out, part, M, Cout, H * W,
                                                       G, bm, segmax)
                                       : reduce_splits<128>(tiles, s, ws, splits, bias, bdt, out, part, M, Cout,
                                                            H * W, G, bm, segmax));
}

// The launch configuration of conv_wgmma_tma_kernel<CONS, STAGED> in
// clusters of `cl` CTAs with `smem` bytes of dynamic shared memory (one
// block an SM), and how many such clusters the card holds at once, per
// device and cluster size (cudaOccupancyMaxActiveClusters; not every SM
// takes part in a cluster: an H100's GPCs hold 16-18 SMs).
template <int CONS, bool STAGED>
cudaError_t conv_tma_config(int cl, int smem, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                            cudaLaunchAttribute* cluster, int* resident) {
  static int cached[16][kMaxCluster + 1] = {};
  if (cl < 1 || cl > kMaxCluster) return cudaErrorInvalidValue;
  auto kernel = conv_wgmma_tma_kernel<CONS, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *cfg = {};
  cfg->blockDim = dim3(128 * (CONS + 1));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = cl;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cfg->attrs = cluster;
  cfg->numAttrs = 1;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess || device >= 16) return err != cudaSuccess ? err : cudaErrorInvalidValue;
  if (cached[device][cl] == 0) {
    cfg->gridDim = dim3(cl);
    err = cudaOccupancyMaxActiveClusters(&cached[device][cl], kernel, cfg);
    if (err != cudaSuccess) return err;
    if (cached[device][cl] < 1) return cudaErrorInvalidConfiguration;
  }
  *resident = cached[device][cl];
  return cudaSuccess;
}

// the kernel's dynamic shared memory: the ring, then after_ring_floats
template <int CONS, bool STAGED>
constexpr int conv_tma_smem(int segmax, bool fused) {
  return 1024 + conv_ring<CONS, STAGED>() * (64 * CONS + kTileN) * kRowBytes +
         4 * after_ring_floats(64 * CONS, STAGED, segmax, fused);
}

template <int CONS, bool STAGED>
cudaError_t launch_conv_tma(int units, int cl, int mcast, cudaStream_t stream, const CUtensorMap& xmap,
                            const CUtensorMap& wmap, const void* bias, int bdt, float* out, float* part,
                            float* ws, int M, int HW, int W, int Cout, int ks, int per_tap, int G, int bm,
                            int segmax, int splits, const FusedNorm& fn) {
  const bool fused = fn.dst != nullptr;
  if (bm > 64 * CONS || segmax > bm || (fused && (!STAGED || segmax > kFuseSegs))) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster[1];
  int resident = 0;
  cudaError_t err = conv_tma_config<CONS, STAGED>(cl, conv_tma_smem<CONS, STAGED>(segmax, fused), stream, &cfg,
                                                  cluster, &resident);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(cl * min(units, resident));  // a persistent grid
  err = cudaLaunchKernelEx(&cfg, conv_wgmma_tma_kernel<CONS, STAGED>, xmap, wmap, bias, bdt, out, part, ws, M, HW,
                           W, Cout, ks, per_tap, G, bm, segmax, splits, cl, mcast, fn);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The bf16 tensor-core conv (Cin % 64 == 0, Cout % 8 == 0, cg | 192) with
// A by TMA: kernel tiles of `tile` in {64, 128} rows, of which bm = W *
// rows * samples hold output pixels (rows whole image rows of one sample,
// H % rows == 0, or samples whole samples); the staged epilogue (finisher
// warps) or the register one, which takes the GroupNorm partials only of
// the groups register_groups takes.  ws and part as conv_tf32x3.  The grid
// is of clusters of `cluster` CTAs along M (at most 8), whose pairs with
// `multicast` share each weight tile.  With fn.dst set the conv is fused
// (FusedNorm; out and part unused): one split, the staged epilogue, groups
// that register_groups takes, and tiles of whole samples, or `cluster`
// tiles that make one sample.
int conv_bf16(const void* x, const void* w, const void* bias, int bdt, float* out, float* part,
              float* ws, int B, int H, int W, int Cin, int Cout, int ks, int G, int tile, int bm, int rows,
              int samples, int staged, int splits, int segmax, int cluster, int multicast, const FusedNorm& fn,
              cudaStream_t s) {
  const int M = B * H * W, K = ks * ks * Cin, HW = H * W;
  if (Cin % Operand<__nv_bfloat16>::kSlice || Cout % 8 || (part != nullptr && kTileN % (Cout / G)) ||
      splits < 1 || (splits > 1 && ws == nullptr) ||
      (!staged && splits == 1 && part != nullptr && !register_groups(Cout, G)))
    return static_cast<int>(cudaErrorInvalidValue);
  // a box of whole rows of one sample, or of whole samples, of at most 256 a side
  if (rows < 1 || samples < 1 || rows > H || H % rows || (samples > 1 && rows != H) || W > 256 ||
      rows > 256 || samples > 256 || bm != W * rows * samples || bm > tile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster < 1 || cluster > kMaxCluster || (multicast && cluster % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fn.dst != nullptr && (splits > 1 || !staged || !register_groups(Cout, G) ||
                            (bm < HW ? cluster * bm != HW : bm % HW != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + bm - 1) / bm, (Cout + kTileN - 1) / kTileN, splits);
  const int units = ((grid.x + cluster - 1) / cluster) * grid.y * grid.z;
  CUtensorMap xmap, wmap;
  cudaError_t err = weight_map<__nv_bfloat16>(&wmap, w, K, Cout, multicast ? kTileN / 2 : kTileN);
  if (err == cudaSuccess) err = activation_map(&xmap, x, B, H, W, Cin, rows, samples);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_tap = Cin / Operand<__nv_bfloat16>::kSlice;
#define NOPE_CONV_TMA(CONS, STAGED)                                                                              \
  launch_conv_tma<CONS, STAGED>(units, cluster, multicast, s, xmap, wmap, bias, bdt, out, part, ws, M, HW, W, Cout, \
                                ks, per_tap, G, bm, segmax, splits, fn)
  if (tile == 128)
    err = staged ? NOPE_CONV_TMA(2, true) : NOPE_CONV_TMA(2, false);
  else if (tile == 64)
    err = staged ? NOPE_CONV_TMA(1, true) : NOPE_CONV_TMA(1, false);
  else
    err = cudaErrorInvalidValue;
#undef NOPE_CONV_TMA
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(reduce_splits(dim3(grid.x, grid.y), s, ws, splits, bias, bdt, out, part, M,
                                        Cout, HW, G, bm, segmax));
}

// How many clusters of `cluster` CTAs of the bf16 conv (tile rows,
// staged) the card holds at once, at its largest shared memory
int conv_bf16_clusters(int tile, int staged, int cluster, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (tile == 128)
    return static_cast<int>(staged ? conv_tma_config<2, true>(cluster, conv_tma_smem<2, true>(kFuseSegs, true), 0,
                                                              &cfg, attr, count)
                                   : conv_tma_config<2, false>(cluster, conv_tma_smem<2, false>(128, false), 0,
                                                               &cfg, attr, count));
  if (tile == 64)
    return static_cast<int>(staged ? conv_tma_config<1, true>(cluster, conv_tma_smem<1, true>(kFuseSegs, true), 0,
                                                              &cfg, attr, count)
                                   : conv_tma_config<1, false>(cluster, conv_tma_smem<1, false>(64, false), 0,
                                                               &cfg, attr, count));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

NOPE_API int nope_conv_nhwc(const void* x, const void* w, const void* bias, float* out,
                            int B, int H, int W, int Cin, int Cout, int ks, int xdt, int wdt,
                            void* stream) {
  const int M = B * H * W;
  const dim3 grid((M + kBM - 1) / kBM, (Cout + kBN - 1) / kBN);
  conv_nhwc_kernel<<<grid, kConvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, B, H, W, Cin, Cout, ks, xdt, wdt);
  return static_cast<int>(cudaGetLastError());
}

// mean and scale: (B, C) float32 tables for gn_silu
NOPE_API int nope_group_stats(const float* h, const void* gamma, int pdt, float* mean,
                              float* scale, int B, int HW, int C, int G, float eps,
                              void* stream) {
  group_stats_kernel<<<B * G, kStatsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h, gamma, pdt, mean, scale, HW, C, G, eps);
  return static_cast<int>(cudaGetLastError());
}

// C % 4 == 0 and C <= 4 * kEltThreads; emb and res may be null, their
// dtype codes are then ignored.  grid_y (1 .. 65,535) blocks share the
// B samples along the grid's y axis.
NOPE_API int nope_gn_silu(const float* h, const float* mean, const float* scale,
                          const void* beta, int pdt, const void* emb, int edt, const void* res,
                          int rdt, void* out, int odt, int B, int HW, int C, int grid_y,
                          void* stream) {
  const int tx = C / 4;
  if (C % 4 || tx > kEltThreads || grid_y < 1 || grid_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ny = max(1, 256 / tx), rows = 8 * ny;
  const dim3 grid((HW + rows - 1) / rows, grid_y);
  gn_silu_kernel<<<grid, dim3(tx, ny), 0, static_cast<cudaStream_t>(stream)>>>(
      h, mean, scale, beta, pdt, emb, edt, res, rdt, out, odt, B, HW, C, rows);
  return static_cast<int>(cudaGetLastError());
}

// The channels-last GroupNorm pair's blocks: (C / V, 256 / (C / V)), V the
// channels of a 16-byte vector of dtype xdt; false where the kernels do not
// take the shape (C % (V G), C > 256 V, G > 32, spans that do not cover HW
// exactly once, grid_y out of 1 .. 65,535)
static bool norm_nhwc_block(int xdt, int HW, int C, int G, int span, int splits, int grid_y, dim3* block) {
  const int vec = xdt == DT_F32 ? NormVec<float>::kV : NormVec<__nv_bfloat16>::kV;
  if ((xdt != DT_F32 && xdt != DT_BF16) || G < 1 || G > kNormMaxGroups || C % (G * vec) ||
      C / vec > kNormThreads || span < 1 || splits < 1 || static_cast<long long>(span) * splits < HW ||
      static_cast<long long>(span) * (splits - 1) >= HW || grid_y < 1 || grid_y > 65535)
    return false;
  *block = dim3(C / vec, kNormThreads / (C / vec));
  return true;
}

// x: (B, HW, C) channels-last, float32 or bf16 (dtype code xdt); addend:
// (B, C) of dtype adt, or null; part: (B, splits, G, 3) float32, (count,
// mean, M2) of each span of `span` pixels.  grid_y blocks share the B
// samples along the grid's y axis.
NOPE_API int nope_gn_nhwc_stats(const void* x, int xdt, const void* addend, int adt, float* part, int B, int HW,
                                int C, int G, int span, int splits, int grid_y, void* stream) {
  dim3 block;
  if (!norm_nhwc_block(xdt, HW, C, G, span, splits, grid_y, &block)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = xdt == DT_F32 ? gn_nhwc_stats_kernel<float> : gn_nhwc_stats_kernel<__nv_bfloat16>;
  kernel<<<dim3(splits, grid_y), block, 0, static_cast<cudaStream_t>(stream)>>>(x, addend, adt, part, B, HW, C, G,
                                                                               span, splits);
  return static_cast<int>(cudaGetLastError());
}

// out (B, HW, C) in x's dtype = SiLU((x - m)·a + d) from nope_gn_nhwc_stats'
// partials (the same x, span, splits and addend); gamma, beta of dtype pdt;
// film (B, 2C) = [scale | shift] of dtype fdt, or null
NOPE_API int nope_gn_nhwc_apply(const void* x, int xdt, const float* part, const void* gamma, const void* beta,
                                int pdt, const void* addend, int adt, const void* film, int fdt, void* out, int B,
                                int HW, int C, int G, int span, int splits, int grid_y, float eps, void* stream) {
  dim3 block;
  if (!norm_nhwc_block(xdt, HW, C, G, span, splits, grid_y, &block)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = xdt == DT_F32 ? gn_nhwc_apply_kernel<float> : gn_nhwc_apply_kernel<__nv_bfloat16>;
  kernel<<<dim3(splits, grid_y), block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, part, gamma, beta, pdt, addend, adt, film, fdt, out, B, HW, C, G, span, splits, eps);
  return static_cast<int>(cudaGetLastError());
}

// bf16 conv on the tensor cores, A by TMA: conv_bf16.
// With dst set, fused: GroupNorm (gamma, beta: bf16, eps) + SiLU + emb (bf16
// (B, Cout), or null) + res ((M, Cout) of dtype rdt, or null) into bf16 dst.
NOPE_API int nope_conv_wgmma(const void* x, const void* w, const void* bias, int bdt, float* out,
                             float* part, float* ws, int B, int H, int W, int Cin, int Cout,
                             int ks, int G, int tile, int bm, int rows, int samples, int staged,
                             int splits, int segmax, int cluster, int multicast, const void* gamma,
                             const void* beta, const void* emb, const void* res, int rdt, void* dst, float eps,
                             void* stream) {
  const FusedNorm fn = {gamma, beta, emb, res, DT_BF16, rdt, static_cast<__nv_bfloat16*>(dst), eps};
  return conv_bf16(x, w, bias, bdt, out, part, ws, B, H, W, Cin, Cout, ks, G, tile, bm, rows, samples,
                   staged, splits, segmax, cluster, multicast, fn, static_cast<cudaStream_t>(stream));
}

// *count = the clusters of `cluster` CTAs of the bf16 conv that the current
// device holds at once (tile rows, staged epilogue or not)
NOPE_API int nope_conv_clusters(int tile, int staged, int cluster, int* count) {
  return conv_bf16_clusters(tile, staged, cluster, count);
}

// float32 conv on the tensor cores in 3xTF32 (Cin % 32 == 0): w is the
// (2, Cout, K) float32 pack of hi = tf32(w) and lo = w - hi; bn, the N
// tile, 192 or (part null) 128.
NOPE_API int nope_conv_tf32x3(const void* x, const void* w, const void* bias, int bdt, float* out,
                              float* part, float* ws, int B, int H, int W, int Cin, int Cout,
                              int ks, int G, int bm, int bn, int splits, int segmax, void* stream) {
  return conv_tf32x3(x, w, bias, bdt, out, part, ws, B, H, W, Cin, Cout, ks, G, bm, bn, splits, segmax,
                     static_cast<cudaStream_t>(stream));
}

NOPE_API int nope_gn_finalize(const float* part, const void* gamma, int pdt, float* mean,
                              float* scale, int B, int HW, int C, int G, int bm, int segmax,
                              float eps, void* stream) {
  const int n = B * G;
  gn_finalize_kernel<<<(n + 3) / 4, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      part, gamma, pdt, mean, scale, B, HW, C, G, bm, segmax, eps);
  return static_cast<int>(cudaGetLastError());
}
