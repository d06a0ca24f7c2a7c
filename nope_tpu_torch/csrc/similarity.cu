// K1: the reference-metric retrieval score.
//
// Replaces nope_tpu/ops/experimental/pallas_similarity.py::_ref_sim_kernel
// (pallas_call in reference_similarity_pallas_cf):
//
//   sim[b, n] = -sum_{h,w} sqrt( sum_c ((q[b,h,w,c] - t[b,n,h,w,c])^2)^2 )
//
// What bounds it on an H100: the CUDA cores' float32 operations (~15 a
// (query, template, pixel) triple, an IEEE sqrtf among them) once every
// input is read from L2 only a few times; the unique input is small (a
// 341-template bf16 bank is 2.8 MB).  A block per (query, template) pair
// would re-read the query for every template and the bank for every
// query, so the design tiles pairs: a block takes TQ queries x TN
// templates over a range of pixels, stages their slices in shared memory
// by 16-byte cp.async (double-buffered steps of 64 pixels; a bf16 pixel
// is 8 bytes, a float32 one 16), and each thread keeps a QR x NR register
// tile of pairs over every (256 / tiles)-th pixel.  L2 traffic falls by
// TQ for the bank and TN for the queries.  A bank with leading dim B
// (one per query) shares no template, so there TQ = 1.  Where there are
// fewer tiles than the card has SMs (the serving requests: 8 queries
// against one object's bank), the pixels are split over blocks and
// reduce_splits sums the splits in order.  Every sum runs in a fixed
// order, so two launches are bitwise equal.  The NHWC layout is read as
// it is (no channel-first transpose); ragged B and N are zero-filled and
// not stored.  Output is always float32, as in the TPU kernel.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 64;  // pixels staged per step

template <bool kBf16, int TQ, int TN, int QR, int NR>
struct Tile {
  static constexpr int kPix = kBf16 ? 8 : 16;  // bytes of one 4-channel pixel
  static constexpr int kTilesQ = TQ / QR, kTilesN = TN / NR;
  static constexpr int kTiles = kTilesQ * kTilesN;
  static constexpr int kLanes = kThreads / kTiles;  // threads that share a register tile
  // padded rows: two templates' rows read in one bf16 phase fall on other banks
  static constexpr int kPitch = kStep * kPix + (kBf16 ? 64 : 16);
  static constexpr int kStage = (TQ + TN) * kPitch;
  static constexpr int kSmem = 2 * kStage;
  static_assert(kLanes * kTiles == kThreads && kStep % kLanes == 0, "tile shape");
  static_assert(QR * NR * kTiles * kLanes * 4 <= kSmem, "the reduction reuses the stages");
};

__device__ __forceinline__ float4 pixel(const unsigned char* p, int dt_bf16) {
  if (!dt_bf16) return *reinterpret_cast<const float4*>(p);
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// grid (N tiles, B tiles, splits).  Block (x, y, z): queries [TQ y, +TQ),
// templates [TN x, +TN), pixels [pixels z, +pixels).  q: (B, S, 4); bank:
// (B or 1, N, S, 4).  With one split out[b, n] = -sum, else ws[z, b, n] = sum.
template <bool kBf16, int TQ, int TN, int QR, int NR>
__global__ void __launch_bounds__(kThreads)
similarity_kernel(const void* __restrict__ q, const void* __restrict__ bank, float* __restrict__ out,
                  float* __restrict__ ws, int B, int N, int S, int bank_batched, int pixels) {
  using T = Tile<kBf16, TQ, TN, QR, NR>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * TN, b0 = blockIdx.y * TQ;
  const int s_begin = blockIdx.z * pixels, s_end = min(S, s_begin + pixels);
  const int lane = threadIdx.x % T::kLanes, tile = threadIdx.x / T::kLanes;
  const int qt = tile / T::kTilesN, nt = tile % T::kTilesN;
  const unsigned char* qb = static_cast<const unsigned char*>(q);
  const unsigned char* tb = static_cast<const unsigned char*>(bank) +
                            (bank_batched ? static_cast<size_t>(b0) * N * S * T::kPix : 0);
  const uint32_t buf = smem_u32(smem);

  // rows 0 .. TQ-1: queries b0 + r; rows TQ ..: templates n0 + r - TQ
  auto stage = [&](uint32_t dst, int s0) {
    constexpr int per_row = kStep * T::kPix / 16;
    for (int i = threadIdx.x; i < (TQ + TN) * per_row; i += kThreads) {
      const int r = i / per_row, ch = i - r * per_row;
      const int s = s0 + ch * (16 / T::kPix);  // first pixel of this 16-byte chunk
      const bool is_q = r < TQ;
      const int idx = is_q ? b0 + r : n0 + r - TQ;
      const bool ok = idx < (is_q ? B : N) && s < s_end;
      const unsigned char* src =
          (is_q ? qb : tb) + (static_cast<size_t>(ok ? idx : 0) * S + (ok ? s : 0)) * T::kPix;
      cp_async_16(dst + r * T::kPitch + ch * 16, src, ok);
    }
  };

  float acc[QR][NR] = {};
  const int steps = (s_end - s_begin + kStep - 1) / kStep;
  stage(buf, s_begin);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) stage(buf + ((st + 1) & 1) * T::kStage, s_begin + (st + 1) * kStep);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* rows = smem + (st & 1) * T::kStage;
#pragma unroll 2
    for (int p = lane; p < kStep; p += T::kLanes) {  // past s_end both sides are zero
      float4 qv[QR], tv[NR];
#pragma unroll
      for (int a = 0; a < QR; ++a) qv[a] = pixel(rows + (a * T::kTilesQ + qt) * T::kPitch + p * T::kPix, kBf16);
#pragma unroll
      for (int j = 0; j < NR; ++j)
        tv[j] = pixel(rows + (TQ + j * T::kTilesN + nt) * T::kPitch + p * T::kPix, kBf16);
#pragma unroll
      for (int a = 0; a < QR; ++a)
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          float d0 = qv[a].x - tv[j].x, d1 = qv[a].y - tv[j].y;
          float d2 = qv[a].z - tv[j].z, d3 = qv[a].w - tv[j].w;
          d0 *= d0; d1 *= d1; d2 *= d2; d3 *= d3;
          acc[a][j] += sqrtf(d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3);
        }
    }
    __syncthreads();
  }

  // the lanes of a register tile, summed in lane order
  float* red = reinterpret_cast<float*>(smem);  // [a][j][tile][lane]
#pragma unroll
  for (int a = 0; a < QR; ++a)
#pragma unroll
    for (int j = 0; j < NR; ++j) red[((a * NR + j) * T::kTiles + tile) * T::kLanes + lane] = acc[a][j];
  __syncthreads();
  for (int pr = threadIdx.x; pr < TQ * TN; pr += kThreads) {
    const int qi = pr / TN, nj = pr % TN;
    const int b = b0 + qi, n = n0 + nj;
    if (b >= B || n >= N) continue;
    const int a = qi / T::kTilesQ, j = nj / T::kTilesN;
    const float* src = red + ((a * NR + j) * T::kTiles + (qi % T::kTilesQ) * T::kTilesN + nj % T::kTilesN) * T::kLanes;
    float s = 0.f;
    for (int l = 0; l < T::kLanes; ++l) s += src[l];
    const size_t o = static_cast<size_t>(b) * N + n;
    if (ws == nullptr) {
      out[o] = -s;
    } else {
      ws[blockIdx.z * static_cast<size_t>(B) * N + o] = s;
    }
  }
}

// out[i] = -sum_z ws[z, i], z in order
__global__ void __launch_bounds__(kThreads)
reduce_splits_kernel(const float* __restrict__ ws, float* __restrict__ out, int count, int splits) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[static_cast<size_t>(z) * count + i];
  out[i] = -s;
}

template <bool kBf16, int TQ, int TN, int QR, int NR>
cudaError_t launch_tiles(const void* q, const void* bank, float* out, float* ws, int B, int N, int S,
                         int bank_batched, int pixels, int splits, cudaStream_t stream) {
  using T = Tile<kBf16, TQ, TN, QR, NR>;
  auto kernel = similarity_kernel<kBf16, TQ, TN, QR, NR>;
  if (T::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + TN - 1) / TN, (B + TQ - 1) / TQ, splits);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(q, bank, out, splits > 1 ? ws : nullptr, B, N, S,
                                                bank_batched, pixels);
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, 4); bank: (B or 1, N, S, 4) (bank_batched: leading dim B);
// out: (B, N) float32.  A block tiles 8 queries of a shared bank and one
// query of a batched bank; the S pixels are split in ranges of `pixels`
// over `splits` blocks, with ws: (splits, B, N) float32 when splits > 1.
NOPE_API int nope_reference_similarity(const void* q, const void* bank, float* out, float* ws, int B,
                                       int N, int S, int bank_batched, int pixels, int splits, int dtype,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((splits > 1) != (ws != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == DT_BF16) {
    err = bank_batched ? launch_tiles<true, 1, 32, 1, 4>(q, bank, out, ws, B, N, S, 1, pixels, splits, s)
                       : launch_tiles<true, 8, 32, 2, 4>(q, bank, out, ws, B, N, S, 0, pixels, splits, s);
  } else {
    err = bank_batched ? launch_tiles<false, 1, 32, 1, 4>(q, bank, out, ws, B, N, S, 1, pixels, splits, s)
                       : launch_tiles<false, 8, 32, 2, 4>(q, bank, out, ws, B, N, S, 0, pixels, splits, s);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int count = B * N;
  reduce_splits_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, s>>>(ws, out, count, splits);
  return static_cast<int>(cudaGetLastError());
}

NOPE_API const char* nope_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
