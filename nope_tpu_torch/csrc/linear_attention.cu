// K2: the inner chain of the U-Net's linear attention.
//
// Replaces nope_tpu/ops/experimental/linear_attention.py::_kernel
// (pallas_call in linear_attention_inner).  Per batch item and head,
// with d = e = dim_head = 32 and n tokens:
//
//   q <- softmax over d, times d^-1/2;   k <- softmax over the n tokens
//   ctx = k^T v  (d x e);                out = q ctx  (n x e)
//
// The input is (B, n, 3 * heads * 32) heads-major, the output
// (B, n, heads * 32) in the input dtype.
//
// What bounds it on an H100: device memory and launch latency, not
// flops (2 * n * 32 * 32 * 2 per head).  One block per (item, head)
// reads its q, k, v columns, each a coalesced 128-byte (float32) row
// segment per token, and never writes an intermediate: pass 1 takes
// k's softmax max and sum over all tokens with a running rescale,
// pass 2 accumulates per-warp 32 x 32 contexts in registers and sums
// them in shared memory in a fixed order, pass 3 applies q's softmax
// and writes n x 32 outputs.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kDh = 32;
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
linear_attention_kernel(const void* __restrict__ qkv, void* __restrict__ out, int n,
                        int heads, float scale, int dt) {
  const int item = blockIdx.x / heads, h = blockIdx.x % heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hidden = heads * kDh;
  const size_t in_stride = 3 * static_cast<size_t>(hidden);
  const size_t row0 = static_cast<size_t>(item) * n;
  const int qcol = h * kDh + lane;
  const int kcol = hidden + qcol;
  const int vcol = 2 * hidden + qcol;

  __shared__ float s_max[kWarps][kDh], s_sum[kWarps][kDh];
  __shared__ float s_kmax[kDh], s_kinv[kDh];
  __shared__ float s_part[kWarps][kDh][kDh + 1];
  __shared__ float s_ctx[kDh][kDh + 1];

  // pass 1: per channel (lane), running max and rescaled sum of exp(k)
  float m = -INFINITY, l = 0.f;
  for (int t = warp; t < n; t += kWarps) {
    const float k = load_f(qkv, (row0 + t) * in_stride + kcol, dt);
    const float mn = fmaxf(m, k);
    l = l * expf(m - mn) + expf(k - mn);
    m = mn;
  }
  s_max[warp][lane] = m;
  s_sum[warp][lane] = l;
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_max[w][lane]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w)
      if (s_sum[w][lane] > 0.f) sum += s_sum[w][lane] * expf(s_max[w][lane] - mx);
    s_kmax[lane] = mx;
    s_kinv[lane] = 1.f / sum;
  }
  __syncthreads();

  // pass 2: this warp's share of ctx[d][e], lane = e
  float acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) acc[d] = 0.f;
  const float kmax = s_kmax[lane], kinv = s_kinv[lane];
  for (int t = warp; t < n; t += kWarps) {
    const size_t row = (row0 + t) * in_stride;
    const float p = expf(load_f(qkv, row + kcol, dt) - kmax) * kinv;  // softmax_k[t, lane]
    const float v = load_f(qkv, row + vcol, dt);
#pragma unroll
    for (int d = 0; d < kDh; ++d) acc[d] += __shfl_sync(kFull, p, d) * v;
  }
#pragma unroll
  for (int d = 0; d < kDh; ++d) s_part[warp][d][lane] = acc[d];
  __syncthreads();
  for (int i = threadIdx.x; i < kDh * kDh; i += blockDim.x) {
    const int d = i / kDh, e = i % kDh;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_part[w][d][e];
    s_ctx[d][e] = s;
  }
  __syncthreads();

  // pass 3: one warp per token, lane = d for the softmax, lane = e for out
  for (int t = warp; t < n; t += kWarps) {
    const float q = load_f(qkv, (row0 + t) * in_stride + qcol, dt);
    const float e = expf(q - warp_max(q));
    const float qs = e / warp_sum(e) * scale;
    float o = 0.f;
#pragma unroll
    for (int d = 0; d < kDh; ++d) o += __shfl_sync(kFull, qs, d) * s_ctx[d][lane];
    store_f(out, (row0 + t) * hidden + qcol, dt, o);
  }
}

}  // namespace

// qkv: (B, n, 3 * heads * 32); out: (B, n, heads * 32), same dtype.
NOPE_API int nope_linear_attention(const void* qkv, void* out, int B, int n, int heads,
                                   float scale, int dtype, void* stream) {
  linear_attention_kernel<<<B * heads, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      qkv, out, n, heads, scale, dtype);
  return static_cast<int>(cudaGetLastError());
}
