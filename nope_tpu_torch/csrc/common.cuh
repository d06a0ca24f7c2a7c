// Shared helpers of the nope_tpu_torch kernels (sm_90a, plain C interface).
//
// Every kernel loads float32 or bfloat16 (chosen at run time by a dtype
// code, uniform across the launch) and accumulates in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define NOPE_API extern "C" __attribute__((visibility("default")))

enum NopeDtype { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float load_f(const void* p, size_t i, int dt) {
  return dt == DT_F32 ? static_cast<const float*>(p)[i]
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (halo, ragged edge)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum over the block (blockDim.x a multiple of 32, at most 1024), in a
// fixed order, returned to every thread.  `scratch` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // an earlier call may still be reading scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp_sum(lane < warps ? scratch[lane] : 0.f);
}
