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
//
// Any channel count C: the tiled kernel reads a pixel as V = C / 4
// four-channel vectors (C % 4 == 0, V <= 32, rows 16-byte aligned) and
// stages the step of pixels the caller picks (ops/similarity.py::
// pixel_step, at most 64 / V), so its shared memory stays that of C = 4;
// V = 1 (C = 4, the kernel above step for step) and V = 2 (C = 8, the
// template encoder's descriptors: 5-16% faster than through the shared
// instance on an H100, scripts/k1_k2_plans.py) are compiled as their own
// instances, and every other V shares one.  Any other C,
// or rows that 16-byte copies cannot take (a bf16 query with an odd
// h*w*C), go to similarity_scalar_kernel: a thread per pair reads its
// elements from global memory one by one.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 64;  // pixels staged per step

template <bool kBf16, int TQ, int TN, int QR, int NR>
struct Tile {
  static constexpr int kPix = kBf16 ? 8 : 16;  // bytes of one 4-channel vector (a C = 4 pixel)
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

// grid (N tiles, grid_y, splits).  Block (x, y, z): templates [TN x, +TN),
// pixels [pixels z, +pixels), and the query tiles y, y + gridDim.y, ...
// (the grid's y extent is capped at 65,535), each queries [TQ y', +TQ).
// q: (B, S, 4 V); bank: (B or 1, N, S, 4 V), a pixel V 4-channel vectors
// (kV, or `vecs` when kV == 0), staged `step` pixels at a time (64 when
// kV = 1).  With one split out[b, n] = -sum, else ws[z, b, n] = sum.
template <bool kBf16, int TQ, int TN, int QR, int NR, int kV>
__global__ void __launch_bounds__(kThreads)
similarity_kernel(const void* __restrict__ q, const void* __restrict__ bank, float* __restrict__ out,
                  float* __restrict__ ws, int B, int N, int S, int bank_batched, int pixels, int vecs,
                  int step) {
  using T = Tile<kBf16, TQ, TN, QR, NR>;
  const int V = kV ? kV : vecs;
  const int P = kV == 1 ? kStep : step;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * TN, q_tiles = (B + TQ - 1) / TQ;
  const int s_begin = blockIdx.z * pixels, s_end = min(S, s_begin + pixels);
  const int lane = threadIdx.x % T::kLanes, tile = threadIdx.x / T::kLanes;
  const int qt = tile / T::kTilesN, nt = tile % T::kTilesN;
  const unsigned char* qb = static_cast<const unsigned char*>(q);
  const uint32_t buf = smem_u32(smem);
  const int steps = (s_end - s_begin + P - 1) / P;
  const size_t row = static_cast<size_t>(S) * V * T::kPix;  // bytes of one query or template

  for (int by = blockIdx.y; by < q_tiles; by += gridDim.y) {
    const int b0 = by * TQ;
    const unsigned char* tb = static_cast<const unsigned char*>(bank) +
                              (bank_batched ? static_cast<size_t>(b0) * N * row : 0);

    // rows 0 .. TQ-1: queries b0 + r; rows TQ ..: templates n0 + r - TQ
    auto stage = [&](uint32_t dst, int s0) {
      const int per_row = P * V * T::kPix / 16;
      for (int i = threadIdx.x; i < (TQ + TN) * per_row; i += kThreads) {
        const int r = i / per_row, ch = i - r * per_row;
        const int s = s0 + ch * (16 / T::kPix) / V;  // first pixel of this 16-byte chunk
        const bool is_q = r < TQ;
        const int idx = is_q ? b0 + r : n0 + r - TQ;
        const bool ok = idx < (is_q ? B : N) && s < s_end;
        const unsigned char* src =
            (is_q ? qb : tb) + (ok ? static_cast<size_t>(idx) * row + static_cast<size_t>(s0) * V * T::kPix + ch * 16 : 0);
        cp_async_16(dst + r * T::kPitch + ch * 16, src, ok);
      }
    };

    float acc[QR][NR] = {};
    stage(buf, s_begin);
    cp_async_commit();
    for (int st = 0; st < steps; ++st) {
      if (st + 1 < steps) stage(buf + ((st + 1) & 1) * T::kStage, s_begin + (st + 1) * P);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const unsigned char* rows = smem + (st & 1) * T::kStage;
#pragma unroll 2
      for (int p = lane; p < P; p += T::kLanes) {  // past s_end both sides are zero
        float e[QR][NR];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int at = (p * V + v) * T::kPix;
          float4 qv[QR], tv[NR];
#pragma unroll
          for (int a = 0; a < QR; ++a) qv[a] = pixel(rows + (a * T::kTilesQ + qt) * T::kPitch + at, kBf16);
#pragma unroll
          for (int j = 0; j < NR; ++j) tv[j] = pixel(rows + (TQ + j * T::kTilesN + nt) * T::kPitch + at, kBf16);
#pragma unroll
          for (int a = 0; a < QR; ++a)
#pragma unroll
            for (int j = 0; j < NR; ++j) {
              float d0 = qv[a].x - tv[j].x, d1 = qv[a].y - tv[j].y;
              float d2 = qv[a].z - tv[j].z, d3 = qv[a].w - tv[j].w;
              d0 *= d0; d1 *= d1; d2 *= d2; d3 *= d3;
              const float sum4 = d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
              e[a][j] = v == 0 ? sum4 : e[a][j] + sum4;
            }
        }
#pragma unroll
        for (int a = 0; a < QR; ++a)
#pragma unroll
          for (int j = 0; j < NR; ++j) acc[a][j] += sqrtf(e[a][j]);
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
    __syncthreads();  // the next query tile's stages overwrite `red`
  }
}

// Any C and any alignment.  grid (ceil(B N / 256), 1, splits): a thread
// per (query, template) pair sums its pixels [pixels z, +pixels), each
// pixel's C channels in order, reading q (B, S, C) and bank (B or 1, N,
// S, C) element by element (the caches serve the re-reads).  Output as
// similarity_kernel's.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
similarity_scalar_kernel(const void* __restrict__ q, const void* __restrict__ bank, float* __restrict__ out,
                         float* __restrict__ ws, int B, int N, int S, int C, int bank_batched, int pixels) {
  const size_t pair = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t count = static_cast<size_t>(B) * N;
  if (pair >= count) return;
  const size_t b = pair / N, n = pair % N, row = static_cast<size_t>(S) * C;
  const size_t qo = b * row, to = (bank_batched ? pair : n) * row;
  const int s_begin = blockIdx.z * pixels, s_end = min(S, s_begin + pixels);
  float acc = 0.f;
  for (int s = s_begin; s < s_end; ++s) {
    float e = 0.f;
    for (int c = 0; c < C; ++c) {
      const size_t i = static_cast<size_t>(s) * C + c;
      float d = load_f(q, qo + i, kBf16) - load_f(bank, to + i, kBf16);
      d *= d;
      e += d * d;
    }
    acc += sqrtf(e);
  }
  if (ws == nullptr) {
    out[pair] = -acc;
  } else {
    ws[blockIdx.z * count + pair] = acc;
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

template <bool kBf16, int TQ, int TN, int QR, int NR, int kV>
cudaError_t launch_tiles(const void* q, const void* bank, float* out, float* ws, int B, int N, int S,
                         int bank_batched, int pixels, int splits, int grid_y, int vecs, int step,
                         cudaStream_t stream) {
  using T = Tile<kBf16, TQ, TN, QR, NR>;
  auto kernel = similarity_kernel<kBf16, TQ, TN, QR, NR, kV>;
  if (T::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + TN - 1) / TN, grid_y, splits);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(q, bank, out, splits > 1 ? ws : nullptr, B, N, S,
                                                bank_batched, pixels, vecs, step);
  return cudaGetLastError();
}

// the tile shapes: 8 queries of a shared bank, one query of a batched bank
template <bool kBf16, int kV>
cudaError_t launch_vector(const void* q, const void* bank, float* out, float* ws, int B, int N, int S,
                          int bank_batched, int pixels, int splits, int grid_y, int vecs, int step,
                          cudaStream_t s) {
  return bank_batched
             ? launch_tiles<kBf16, 1, 32, 1, 4, kV>(q, bank, out, ws, B, N, S, 1, pixels, splits, grid_y, vecs, step, s)
             : launch_tiles<kBf16, 8, 32, 2, 4, kV>(q, bank, out, ws, B, N, S, 0, pixels, splits, grid_y, vecs, step, s);
}

template <bool kBf16>
cudaError_t launch_scalar(const void* q, const void* bank, float* out, float* ws, int B, int N, int S, int C,
                          int bank_batched, int pixels, int splits, cudaStream_t stream) {
  const size_t blocks = (static_cast<size_t>(B) * N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  similarity_scalar_kernel<kBf16><<<dim3(static_cast<unsigned>(blocks), 1, splits), kThreads, 0, stream>>>(
      q, bank, out, splits > 1 ? ws : nullptr, B, N, S, C, bank_batched, pixels);
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, C); bank: (B or 1, N, S, C) (bank_batched: leading dim B);
// out: (B, N) float32.  `step` > 0 takes the tiled kernel, staging `step`
// pixels at a time (C % 4 == 0, C <= 128, 64 at C = 4, at most 64 / (C / 4)
// and whole 16-byte chunks otherwise; q, bank and every row 16-byte
// aligned; `pixels` a whole number of steps), which tiles 8 queries of a
// shared bank and one query of a batched bank, grid_y (1 .. 65,535) blocks
// sharing the query tiles along the grid's y axis; `step` 0 the scalar
// kernel.
// The S pixels are split in ranges of `pixels` over `splits` blocks,
// with ws: (splits, B, N) float32 when splits > 1.
NOPE_API int nope_reference_similarity(const void* q, const void* bank, float* out, float* ws, int B,
                                       int N, int S, int C, int bank_batched, int step, int pixels,
                                       int splits, int grid_y, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((splits > 1) != (ws != nullptr) || grid_y < 1 || grid_y > 65535 || C < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = dtype == DT_BF16;
  const int elem = bf16 ? 2 : 4;
  cudaError_t err;
  if (step > 0) {
    const int vecs = C / 4;
    const bool fits = C % 4 == 0 && vecs <= 32 && step * vecs <= kStep && (vecs > 1 || step == kStep) &&
                      (static_cast<size_t>(step) * C * elem) % 16 == 0;
    const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 && reinterpret_cast<uintptr_t>(bank) % 16 == 0 &&
                         (static_cast<size_t>(S) * C * elem) % 16 == 0;
    if (!fits || !aligned || pixels % step) return static_cast<int>(cudaErrorInvalidValue);
    const int g = grid_y;
    if (bf16) {
      err = vecs == 1   ? launch_vector<true, 1>(q, bank, out, ws, B, N, S, bank_batched, pixels, splits, g, 1, step, s)
            : vecs == 2 ? launch_vector<true, 2>(q, bank, out, ws, B, N, S, bank_batched, pixels, splits, g, 2, step, s)
                        : launch_vector<true, 0>(q, bank, out, ws, B, N, S, bank_batched, pixels, splits, g, vecs, step, s);
    } else {
      err = vecs == 1   ? launch_vector<false, 1>(q, bank, out, ws, B, N, S, bank_batched, pixels, splits, g, 1, step, s)
            : vecs == 2 ? launch_vector<false, 2>(q, bank, out, ws, B, N, S, bank_batched, pixels, splits, g, 2, step, s)
                        : launch_vector<false, 0>(q, bank, out, ws, B, N, S, bank_batched, pixels, splits, g, vecs, step, s);
    }
  } else {
    err = bf16 ? launch_scalar<true>(q, bank, out, ws, B, N, S, C, bank_batched, pixels, splits, s)
               : launch_scalar<false>(q, bank, out, ws, B, N, S, C, bank_batched, pixels, splits, s);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int count = B * N;
  reduce_splits_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, s>>>(ws, out, count, splits);
  return static_cast<int>(cudaGetLastError());
}

NOPE_API const char* nope_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
