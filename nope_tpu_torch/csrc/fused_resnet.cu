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
// memory a block may use.  So the block runs as three kernels here:
//
//   conv_nhwc      implicit-GEMM conv (k = 3 with zero padding, or k = 1
//                  for the residual projection) + bias, float32 out;
//   group_stats    two-pass mean and variance per (sample, group);
//   gn_silu        normalise + affine + SiLU, whose epilogue adds emb
//                  (after the first conv) or the residual (after the
//                  second) and stores in the output dtype.
//
// What bounds it on an H100: the convolutions' flops (about 95% of the
// U-Net's).  This first version runs them on the CUDA cores in float32
// (64 x 64 output tiles, 4 x 4 per thread, operands staged in shared
// memory), well below the tensor cores' rate; wgmma/TMA is later work.
// The intermediates stay float32 in device memory, as the TPU kernel
// kept them float32 in VMEM.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kConvThreads = 256;
constexpr int kStatsThreads = 512;
constexpr int kEltThreads = 256;

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

// One block per (sample, group): mean, then the mean of squared
// deviations from it (two passes; no E[x^2] - mean^2 cancellation).
__global__ void __launch_bounds__(kStatsThreads)
group_stats_kernel(const float* __restrict__ h, float* __restrict__ mean,
                   float* __restrict__ rstd, int HW, int C, int G, float eps) {
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
  if (threadIdx.x == 0) {
    mean[blockIdx.x] = mu;
    rstd[blockIdx.x] = 1.f / sqrtf(var + eps);
  }
}

// out = SiLU((h - mean) * rstd * gamma + beta) [+ emb[b, c]] [+ res[i]]
__global__ void __launch_bounds__(kEltThreads)
gn_silu_kernel(const float* __restrict__ h, const float* __restrict__ mean,
               const float* __restrict__ rstd, const void* __restrict__ gamma,
               const void* __restrict__ beta, int pdt, const void* __restrict__ emb,
               int edt, const void* __restrict__ res, int rdt, void* __restrict__ out,
               int odt, int HW, int C, int G, size_t total) {
  const int cg = C / G;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kEltThreads + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * kEltThreads) {
    const int c = static_cast<int>(i % C);
    const size_t b = i / (static_cast<size_t>(HW) * C);
    const size_t sg = b * G + c / cg;
    float y = (h[i] - mean[sg]) * rstd[sg] * load_f(gamma, c, pdt) + load_f(beta, c, pdt);
    y = y / (1.f + expf(-y));
    if (emb != nullptr) y += load_f(emb, b * C + c, edt);
    if (res != nullptr) y += load_f(res, i, rdt);
    store_f(out, i, odt, y);
  }
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

NOPE_API int nope_group_stats(const float* h, float* mean, float* rstd, int B, int HW, int C,
                              int G, float eps, void* stream) {
  group_stats_kernel<<<B * G, kStatsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h, mean, rstd, HW, C, G, eps);
  return static_cast<int>(cudaGetLastError());
}

// emb and res may be null; their dtype codes are then ignored.
NOPE_API int nope_gn_silu(const float* h, const float* mean, const float* rstd,
                          const void* gamma, const void* beta, int pdt, const void* emb,
                          int edt, const void* res, int rdt, void* out, int odt, int B,
                          int HW, int C, int G, void* stream) {
  const size_t total = static_cast<size_t>(B) * HW * C;
  const size_t want = (total + kEltThreads - 1) / kEltThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  gn_silu_kernel<<<blocks, kEltThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h, mean, rstd, gamma, beta, pdt, emb, edt, res, rdt, out, odt, HW, C, G, total);
  return static_cast<int>(cudaGetLastError());
}
