// K1: the reference-metric retrieval score.
//
// Replaces nope_tpu/ops/experimental/pallas_similarity.py::_ref_sim_kernel
// (pallas_call in reference_similarity_pallas_cf):
//
//   sim[b, n] = -sum_{h,w} sqrt( sum_c ((q[b,h,w,c] - t[b,n,h,w,c])^2)^2 )
//
// What bounds it on an H100: device memory.  Each bank element is read
// once and costs a few flops, far below the card's flop/byte balance.
// The design streams the bank in its NHWC layout: with C = 4 one pixel
// is one 16-byte float32 load or one 8-byte bfloat16 load, so the TPU
// kernel's channel-first transpose has no purpose here.  One block per
// (template, query) reduces the h*w pixels; a bank with leading dim 1
// serves every query of the batch without being copied.  Output is
// always float32, as in the TPU kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 load_pixel4(const void* p, size_t pixel, int dt) {
  if (dt == DT_F32) return static_cast<const float4*>(p)[pixel];
  const uint2 raw = static_cast<const uint2*>(p)[pixel];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__global__ void __launch_bounds__(kThreads)
reference_similarity_kernel(const void* __restrict__ q, const void* __restrict__ bank,
                            float* __restrict__ out, int N, int S, int bank_batched,
                            int dt) {
  const int n = blockIdx.x, b = blockIdx.y;
  const size_t q0 = static_cast<size_t>(b) * S;
  const size_t t0 = (static_cast<size_t>(bank_batched ? b : 0) * N + n) * S;
  float acc = 0.f;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const float4 qv = load_pixel4(q, q0 + s, dt);
    const float4 tv = load_pixel4(bank, t0 + s, dt);
    float d0 = qv.x - tv.x, d1 = qv.y - tv.y, d2 = qv.z - tv.z, d3 = qv.w - tv.w;
    d0 *= d0; d1 *= d1; d2 *= d2; d3 *= d3;
    acc += sqrtf(d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3);
  }
  __shared__ float scratch[32];
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) out[static_cast<size_t>(b) * N + n] = -acc;
}

}  // namespace

// q: (B, S, 4); bank: (B or 1, N, S, 4); out: (B, N) float32.
NOPE_API int nope_reference_similarity(const void* q, const void* bank, float* out, int B,
                                       int N, int S, int bank_batched, int dtype,
                                       void* stream) {
  const dim3 grid(N, B);
  reference_similarity_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, bank, out, N, S, bank_batched, dtype);
  return static_cast<int>(cudaGetLastError());
}

NOPE_API const char* nope_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
