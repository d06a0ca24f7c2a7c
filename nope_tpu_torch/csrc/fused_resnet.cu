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
// memory a block may use.  So the block runs as a chain of kernels.
//
// The tensor-core route (bfloat16, the serving dtype, and float32) --
// what bounds it on an H100 is the convolutions' operations (~29 GFLOP a
// sample over the U-Net's 22 blocks, against ~1 MB of activations), so
// they run on the tensor cores:
//
//   conv_wgmma     implicit-GEMM conv, M = B*H*W pixels, N = Co, K =
//                  ks*ks*Cin ordered (tap, ci), float32 accumulators.  A
//                  K-slice is one tap and one 128-byte row of a shifted
//                  NHWC pixel (64 bf16 or 32 float32 channels): every
//                  thread gathers A rows by 16-byte cp.async, zero-filled
//                  for the halo; one thread asks the TMA for the weight
//                  tile.  Both land in a ring of 128-byte-swizzled slots
//                  that runs ahead of the tensor cores.  Tiles of 64 or
//                  192 rows (one warpgroup per 64) by 192 columns: the N
//                  tile holds whole GroupNorm groups (cg in {24, 48, 96,
//                  192}), so the epilogue adds the bias, stores the
//                  float32 pre-norm output and writes per tile a partial
//                  (count, mean, M2) for every (sample, group) it touches.
//                  Few tiles (the 4x4 to 16x16 stages at small batch)
//                  split K over blocks; splitk_reduce sums the splits in a
//                  fixed order.  The 1x1 residual is the same kernel with
//                  one tap;
//   gn_finalize    merges a (sample, group)'s partials in tile order with
//                  Chan's formula (no E[x^2] - mean^2 cancellation) into
//                  per-channel tables;
//   gn_silu        as below, storing the first Block's activation in the
//                  block's dtype: in bf16 the second conv's operand,
//                  rounded as the TPU's MXU rounded its float32 scratch at
//                  default precision; in float32 kept whole.
//
// bfloat16: wgmma m64n192k16 on bf16 operands (989 TFLOP/s).
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
// output is written once and read once more, by gn_silu.
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

// GroupNorm of (sample b, group g) as per-channel tables the normalise
// pass reads: mean[b, c] = mu, scale[b, c] = gamma[c] / sqrt(var + eps)
__device__ __forceinline__ void write_norm_tables(float* mean, float* scale, const void* gamma,
                                                  int pdt, int b, int g, int C, int cg,
                                                  float mu, float var, float eps, int first,
                                                  int step) {
  const float rs = 1.f / sqrtf(var + eps);
  for (int c = g * cg + first; c < (g + 1) * cg; c += step) {
    mean[static_cast<size_t>(b) * C + c] = mu;
    scale[static_cast<size_t>(b) * C + c] = rs * load_f(gamma, c, pdt);
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
  write_norm_tables(mean, scale, gamma, pdt, b, g, C, cg, mu, var, eps, threadIdx.x, kStatsThreads);
}

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

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
      float4 y = make_float4(silu((v.x - mu.x) * sc.x + be.x) + em.x,
                             silu((v.y - mu.y) * sc.y + be.y) + em.y,
                             silu((v.z - mu.z) * sc.z + be.z) + em.z,
                             silu((v.w - mu.w) * sc.w + be.w) + em.w);
      if (res != nullptr) {
        const float4 r = load4(res, i, rdt);
        y = make_float4(y.x + r.x, y.y + r.y, y.z + r.z, y.w + r.w);
      }
      store4(out, i, odt, y);
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

// A K-slice is one tap x kSlice channels (one 128-byte row); a wgmma step
// reads 32 bytes of every row.  float32 operands arrive as kPlanes = 2
// tf32 planes (hi, lo), so a stage holds A and B twice.
template <typename T>
struct Operand;
template <>
struct Operand<__nv_bfloat16> {
  static constexpr int kSlice = 64, kPlanes = 1;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Operand<float> {
  static constexpr int kSlice = 32, kPlanes = 2;
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

// wait for this warpgroup's wgmma groups
__device__ __forceinline__ void wgmma_wait(float (&d)[96]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  // the accumulators are read only after the wait
#pragma unroll
  for (int i = 0; i < 96; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The epilogue of one (BM x 192) tile staged as float32 in shared memory
// (row pitch kPitch, then 2 x 192 floats of scratch): add the bias, store
// rows m0.. of `out` (M, Cout), and, when `part` is given, write the
// tile's partial GroupNorm statistics: for every (sample, group) it
// touches, (count, mean, M2) at part[((mt * G + g) * segmax + s) * 3],
// s = sample - first sample of the tile.
__device__ void finish_tile(float* stage, int bm, int mt, int n0, int M, int Cout, int HW,
                            int G, int segmax, const void* bias, int bdt,
                            float* __restrict__ out, float* __restrict__ part) {
  const int m0 = mt * bm;
  const int rows = min(bm, M - m0), cols = min(kTileN, Cout - n0);
  for (int i = threadIdx.x; i < rows * (kTileN / 4); i += blockDim.x) {
    const int r = i / (kTileN / 4), c = 4 * (i % (kTileN / 4));
    if (c >= cols) continue;
    float4 v = *reinterpret_cast<float4*>(&stage[r * kPitch + c]);
    v.x += load_f(bias, n0 + c, bdt);
    v.y += load_f(bias, n0 + c + 1, bdt);
    v.z += load_f(bias, n0 + c + 2, bdt);
    v.w += load_f(bias, n0 + c + 3, bdt);
    *reinterpret_cast<float4*>(&stage[r * kPitch + c]) = v;
    *reinterpret_cast<float4*>(&out[static_cast<size_t>(m0 + r) * Cout + n0 + c]) = v;
  }
  if (part == nullptr) return;
  // per sample segment: column sums, each thread down its own column
  // (conflict-free), then per group; the mean, then the same for M2
  float* colsum = stage + bm * kPitch;
  float* gmean = colsum + kTileN;
  const int cg = Cout / G, ng = cols / cg;
  const int b0 = m0 / HW, nseg = (m0 + rows - 1) / HW - b0 + 1;
  for (int s = 0; s < nseg; ++s) {
    const int ra = max(m0, (b0 + s) * HW) - m0, rb = min(m0 + rows, (b0 + s + 1) * HW) - m0;
    const float n = static_cast<float>((rb - ra) * cg);
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      float a = 0.f;
      for (int r = ra; r < rb; ++r) a += stage[r * kPitch + c];
      colsum[c] = a;
    }
    __syncthreads();
    for (int g = threadIdx.x; g < ng; g += blockDim.x) {
      float a = 0.f;
      for (int c = g * cg; c < (g + 1) * cg; ++c) a += colsum[c];
      gmean[g] = a / n;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const float mu = gmean[c / cg];
      float a = 0.f;
      for (int r = ra; r < rb; ++r) {
        const float d = stage[r * kPitch + c] - mu;
        a += d * d;
      }
      colsum[c] = a;
    }
    __syncthreads();
    for (int g = threadIdx.x; g < ng; g += blockDim.x) {
      float a = 0.f;
      for (int c = g * cg; c < (g + 1) * cg; ++c) a += colsum[c];
      float* o = part + ((static_cast<size_t>(mt) * G + n0 / cg + g) * segmax + s) * 3;
      o[0] = n;
      o[1] = gmean[g];
      o[2] = a;
    }
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
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

// out[m, co] = bias[co] + sum_{tap, ci} x[pixel(m) + shift(tap), ci] * w[co, tap, ci]
// x: (B, H, W, Cin) NHWC of T, Cin % kSlice == 0; w: (Cout, ks*ks*Cin) of T
// (float32: the hi plane, then the lo plane), read through the TMA maps
// `wmap` (and `wmap_lo`), boxes of 192 rows x one K-slice, swizzled.
// Block (mt, nt, split) takes K-slices [kt0, kt1) of tile (mt, nt) with
// BM/64 warpgroups, which all multiply and all gather the A tiles
// (cp.async); one thread asks the TMA for each B tile.  A ring of STAGES
// slots runs ahead of the tensor cores.  With one split the block
// finishes the tile; with more it stores its raw sums to ws[split] for
// splitk_reduce.
template <typename T, int BM, int STAGES>
__global__ void __launch_bounds__(BM * 2, 1)
conv_wgmma_kernel(const T* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap wmap_lo, const void* __restrict__ bias,
                  int bdt, float* __restrict__ out, float* __restrict__ part,
                  float* __restrict__ ws, int B, int H, int W, int Cin, int Cout, int ks, int G,
                  int segmax, int splits) {
  constexpr int kSlice = Operand<T>::kSlice, kPlanes = Operand<T>::kPlanes;
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte chunk
  constexpr int kThreads = BM * 2, kRowStep = kThreads / 8;
  // a stage: A hi, [A lo,] B hi, [B lo]
  constexpr int kABytes = BM * kRowBytes, kBBytes = kTileN * kRowBytes;
  constexpr int kStageBytes = kPlanes * (kABytes + kBBytes);
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles sit on 1024-byte boundaries (the swizzle's period)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (ring - raw);
  __shared__ __align__(8) uint64_t full[STAGES];  // a slot's B tile has landed
  const uint32_t bar = smem_u32(full);

  const int tid = threadIdx.x, wg = tid >> 7, chunk = tid & 7;
  const int M = B * H * W, pad = ks / 2;
  const int mt = blockIdx.x, m0 = mt * BM, n0 = blockIdx.y * kTileN, split = blockIdx.z;
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
    const uint32_t sa = ring + slot * kStageBytes, sb = sa + kPlanes * kABytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + i * kRowStep;
      const int yy = ay[i] + dy, xx = ax[i] + dx;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const T* src = ok ? x + static_cast<size_t>(am[i] + dy * W + dx) * Cin + c0 : x;
      cp_async_16(sa + r * kRowBytes + ((chunk ^ (r & 7)) << 4), src, ok);
    }
    if (tid == 0) {  // rows past Cout arrive as zeros
      mbar_expect_tx(bar + 8 * slot, kPlanes * kBBytes);
      tma_load_2d(sb, &wmap, kt * kSlice, n0, bar + 8 * slot);
      if constexpr (kPlanes == 2) tma_load_2d(sb + kBBytes, &wmap_lo, kt * kSlice, n0, bar + 8 * slot);
    }
  };

  // float32: this thread's own A chunks of `slot`, once they have landed,
  // become hi in place and lo = x - hi at the same offset of the lo slot
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

  // float32: each K-slice's products go into acc from zero, and acc into
  // `total` with round-to-nearest adds.  The tensor cores' accumulation
  // truncates: across a 20,736-deep K it drifted ~1e-4 of the output.
  float acc[96], total[kPlanes == 2 ? 96 : 1];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kPlanes == 2 ? 96 : 1); ++i) total[i] = 0.f;

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
    if constexpr (kPlanes == 2) split_stage(slot);
    // this thread's copies (and splits) of `slot` are done; make them
    // visible to the tensor cores (async proxy), then wait for every thread's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    mbar_wait(bar + 8 * slot, (i / STAGES) & 1);
    const uint32_t sa = ring + slot * kStageBytes + wg * 64 * kRowBytes;
    const uint32_t sb = ring + slot * kStageBytes + kPlanes * kABytes;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // 32 bytes of every row a step
      if constexpr (kPlanes == 2) {  // small terms first: lo*hi, hi*lo, hi*hi
        wgmma_m64n192k8_tf32(acc, smem_desc(sa + kABytes + 32 * k), smem_desc(sb + 32 * k), k > 0);
        wgmma_m64n192k8_tf32(acc, smem_desc(sa + 32 * k), smem_desc(sb + kBBytes + 32 * k), 1);
        wgmma_m64n192k8_tf32(acc, smem_desc(sa + 32 * k), smem_desc(sb + 32 * k), 1);
      } else {
        wgmma_m64n192k16(acc, smem_desc(sa + 32 * k), smem_desc(sb + 32 * k));
      }
    }
    wgmma_commit();
    // refill the slot of K-slice i - 1: every warpgroup waited for that
    // slice's wgmma before the barrier above
    if (kt + kAhead < kt1) load_stage((i + kAhead) % STAGES, kt + kAhead);
    cp_async_commit();
    wgmma_wait(acc);
    if constexpr (kPlanes == 2) {
#pragma unroll
      for (int j = 0; j < 96; ++j) total[j] += acc[j];
    }
  }
  if constexpr (kPlanes == 2) {
#pragma unroll
    for (int j = 0; j < 96; ++j) acc[j] = total[j];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the staged tile

  // accumulator layout of m64nNkK: thread (warp, lane) of a warpgroup holds
  // rows 16 warp + lane/4 (+8), columns 8 j + 2 (lane % 4) (+1)
  float* stage = reinterpret_cast<float*>(smem);
  const int lane = tid & 31, r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(&stage[r0 * kPitch + c]) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(&stage[(r0 + 8) * kPitch + c]) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  if (splits == 1) {
    finish_tile(stage, BM, mt, n0, M, Cout, H * W, G, segmax, bias, bdt, out, part);
    return;
  }
  float* dst = ws + static_cast<size_t>(split) * M * Cout;
  const int rows = min(BM, M - m0), cols = min(kTileN, Cout - n0);
  for (int i = tid; i < rows * (kTileN / 4); i += kThreads) {
    const int r = i / (kTileN / 4), c = 4 * (i % (kTileN / 4));
    if (c < cols)
      *reinterpret_cast<float4*>(&dst[static_cast<size_t>(m0 + r) * Cout + n0 + c]) =
          *reinterpret_cast<const float4*>(&stage[r * kPitch + c]);
  }
}

// Sum the splits of one (bm x 192) tile in split order, then finish it.
__global__ void __launch_bounds__(kEpiThreads)
splitk_reduce_kernel(const float* __restrict__ ws, int splits, const void* __restrict__ bias,
                     int bdt, float* __restrict__ out, float* __restrict__ part, int M,
                     int Cout, int HW, int G, int bm, int segmax) {
  extern __shared__ float stage_f[];
  const int mt = blockIdx.x, m0 = mt * bm, n0 = blockIdx.y * kTileN;
  const int rows = min(bm, M - m0), cols = min(kTileN, Cout - n0);
  for (int i = threadIdx.x; i < rows * (kTileN / 4); i += kEpiThreads) {
    const int r = i / (kTileN / 4), c = 4 * (i % (kTileN / 4));
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
    *reinterpret_cast<float4*>(&stage_f[r * kPitch + c]) = a;
  }
  __syncthreads();
  finish_tile(stage_f, bm, mt, n0, M, Cout, HW, G, segmax, bias, bdt, out, part);
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
      const float qb = __shfl_sync(0xffffffffu, pq, t);
      const float nt = n + nb, d = mb - mu;
      mu += d * (nb / nt);
      m2 += qb + d * d * (n * nb / nt);
      n = nt;
    }
  }
  write_norm_tables(mean, scale, gamma, pdt, b, g, C, C / G, mu, m2 / n, eps, lane, 32);
}

template <typename T, int BM, int STAGES>
cudaError_t launch_conv_wgmma(dim3 grid, cudaStream_t stream, const void* x, const CUtensorMap& w,
                              const CUtensorMap& w_lo, const void* bias, int bdt, float* out,
                              float* part, float* ws, int B, int H, int W, int Cin, int Cout,
                              int ks, int G, int segmax, int splits) {
  constexpr int kRing = STAGES * Operand<T>::kPlanes * (BM + kTileN) * kRowBytes;
  constexpr int kSmem = kRing + 1024;
  static_assert((BM * kPitch + 2 * kTileN) * 4 <= kRing, "the staged tile exceeds the ring");
  static_assert(kSmem + 8 * STAGES <= 232448, "the ring exceeds a block's shared memory");
  auto kernel = conv_wgmma_kernel<T, BM, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BM * 2, kSmem, stream>>>(static_cast<const T*>(x), w, w_lo, bias, bdt, out, part,
                                          ws, B, H, W, Cin, Cout, ks, G, segmax, splits);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The TMA map of a packed weight plane (Cout, K) of T: boxes of 192 rows
// x one K-slice (128 bytes), 128-byte swizzle, as the wgmma descriptors read.
template <typename T>
cudaError_t weight_map(CUtensorMap* map, const void* w, int K, int Cout) {
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
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(Cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(T)};
  const cuuint32_t box[2] = {Operand<T>::kSlice, kTileN};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, Operand<T>::kMapType, 2, const_cast<void*>(w), dims, strides, box,
                            steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor-core conv of T (Cin % kSlice == 0, Cout % 8 == 0, cg | 192):
// bm in {64, 192} rows per tile; with splits > 1, ws holds splits * M *
// Cout floats.  part (may be null) receives the tiles' GroupNorm partials,
// (ceil(M / bm), G, segmax, 3) floats.  Tiles and rings: bf16 192 rows
// (4 x 48 KB, one block an SM) or 64 (3 x 32 KB, two); float32 128 rows
// (2 x 80 KB) or 64 (3 x 64 KB), one block an SM either way: a thread
// holds 96 accumulators and their 96 running totals, which 192-row
// blocks' 384 threads have no registers for.
template <typename T>
int conv_tensor_cores(const void* x, const void* w, const void* bias, int bdt, float* out,
                      float* part, float* ws, int B, int H, int W, int Cin, int Cout, int ks, int G,
                      int bm, int splits, int segmax, cudaStream_t s) {
  const int M = B * H * W, K = ks * ks * Cin;
  if (Cin % Operand<T>::kSlice || Cout % 8 || (part != nullptr && kTileN % (Cout / G)) ||
      splits < 1 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + bm - 1) / bm, (Cout + kTileN - 1) / kTileN, splits);
  CUtensorMap wmap, wmap_lo;
  cudaError_t err = weight_map<T>(&wmap, w, K, Cout);
  if (err != cudaSuccess) return static_cast<int>(err);
  wmap_lo = wmap;
  if (Operand<T>::kPlanes == 2) {  // the lo plane follows the hi plane
    err = weight_map<T>(&wmap_lo, static_cast<const T*>(w) + static_cast<size_t>(Cout) * K, K, Cout);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr bool kSplit = Operand<T>::kPlanes == 2;
  constexpr int kBig = kSplit ? 128 : 192, kBigStages = kSplit ? 2 : 4;
  if (bm == kBig)
    err = launch_conv_wgmma<T, kBig, kBigStages>(grid, s, x, wmap, wmap_lo, bias, bdt, out, part, ws,
                                                 B, H, W, Cin, Cout, ks, G, segmax, splits);
  else if (bm == 64)
    err = launch_conv_wgmma<T, 64, 3>(grid, s, x, wmap, wmap_lo, bias, bdt, out, part, ws, B, H, W,
                                      Cin, Cout, ks, G, segmax, splits);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int smem = (bm * kPitch + 2 * kTileN) * 4;
  err = cudaFuncSetAttribute(splitk_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  splitk_reduce_kernel<<<dim3(grid.x, grid.y), kEpiThreads, smem, s>>>(
      ws, splits, bias, bdt, out, part, M, Cout, H * W, G, bm, segmax);
  return static_cast<int>(cudaGetLastError());
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

// bf16 conv on the tensor cores (Cin % 64 == 0): conv_tensor_cores.
NOPE_API int nope_conv_wgmma(const void* x, const void* w, const void* bias, int bdt, float* out,
                             float* part, float* ws, int B, int H, int W, int Cin, int Cout,
                             int ks, int G, int bm, int splits, int segmax, void* stream) {
  return conv_tensor_cores<__nv_bfloat16>(x, w, bias, bdt, out, part, ws, B, H, W, Cin, Cout, ks, G,
                                          bm, splits, segmax, static_cast<cudaStream_t>(stream));
}

// float32 conv on the tensor cores in 3xTF32 (Cin % 32 == 0): w is the
// (2, Cout, K) float32 pack of hi = tf32(w) and lo = w - hi.
NOPE_API int nope_conv_tf32x3(const void* x, const void* w, const void* bias, int bdt, float* out,
                              float* part, float* ws, int B, int H, int W, int Cin, int Cout,
                              int ks, int G, int bm, int splits, int segmax, void* stream) {
  return conv_tensor_cores<float>(x, w, bias, bdt, out, part, ws, B, H, W, Cin, Cout, ks, G, bm,
                                  splits, segmax, static_cast<cudaStream_t>(stream));
}

NOPE_API int nope_gn_finalize(const float* part, const void* gamma, int pdt, float* mean,
                              float* scale, int B, int HW, int C, int G, int bm, int segmax,
                              float eps, void* stream) {
  const int n = B * G;
  gn_finalize_kernel<<<(n + 3) / 4, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      part, gamma, pdt, mean, scale, B, HW, C, G, bm, segmax, eps);
  return static_cast<int>(cudaGetLastError());
}
