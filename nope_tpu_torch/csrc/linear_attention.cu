// K2: the inner chain of the U-Net's linear attention.
//
// Replaces nope_tpu/ops/experimental/linear_attention.py::_kernel
// (pallas_call in linear_attention_inner).  Per batch item and head,
// with d = e = dim_head = 32 and n tokens:
//
//   q <- softmax over d, times d^-1/2;   k <- softmax over the n tokens
//   ctx = k^T v  (d x e);                out = q ctx  (n x e)
//
// The input is (B, n, 3 * 4 * 32) heads-major, so one token's q, k and v
// for all 4 heads are three contiguous 128-channel rows; the output is
// (B, n, 4 * 32) in the input dtype.
//
// What bounds it on an H100: device memory (each input byte is read
// once, 2 * 32 operations a channel for the two products), so the card
// has to be filled: the U-Net's 26-item batch is only 104 (item, head)
// pairs.  The tokens of an item are split into chunks, one block per
// (item, chunk), all 4 heads; the plan (ops/linear_attention.py) makes
// items x chunks at least 1.5 x the SM count where n allows.  A block
// stages 32 tokens at a time by 16-byte cp.async, double-buffered, and
// keeps a running column max of k (flash style), so a chunk of any
// length is one pass:
//
//   la_chunk   per (item, chunk, head): m[d] = max_t k[t, d], l[d] =
//              sum_t exp(k[t, d] - m[d]), ctx_c[d][e] = sum_t exp(k[t, d]
//              - m[d]) v[t, e], as float32 partials.  With one chunk it
//              finishes the whole chain itself (one launch, no merge);
//   la_merge   per (item, head), over the chunks in order: M = max m_c,
//              ctx = sum_c ctx_c exp(m_c - M) / sum_c l_c exp(m_c - M)
//              (its own launch: merging inside each output block re-reads
//              the partials per block and was slower on an H100);
//   la_output  per (item, chunk): q's softmax, out = q ctx.
//
// bfloat16: both contractions run on the tensor cores, mma.sync m16n8k16
// with bf16 operands and float32 accumulators.  The softmaxed k, the q
// weights and ctx are rounded to bf16 as operands, as the TPU kernel fed
// its MXU a bf16 softmax tile.  (wgmma needs 64-row tiles; a head's
// product is 32 x 32.)  float32: the same split and merge with CUDA-core
// FMAs out of shared memory, a 4 x 4 register tile a thread.  Every sum
// runs in a fixed order and nothing is atomic, so two launches on the
// same inputs are bitwise equal.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kDh = 32, kHeads = 4, kHidden = kHeads * kDh;
constexpr int kThreads = 256;
constexpr int kSub = 32;                    // tokens staged per step
constexpr int kPart = 2 * kDh + kDh * kDh;  // floats of one partial: m, l, ctx_c
constexpr int kMaxChunks = 64;
constexpr int kCtxPitch = 40;               // bf16 per row of the transposed ctx in smem
constexpr unsigned kFull = 0xffffffffu;

template <bool kBf16>
struct Layout {
  static constexpr int kElem = kBf16 ? 2 : 4;
  static constexpr int kInRow = 3 * kHidden * kElem;  // bytes of one token of qkv
  static constexpr int kQBytes = kHidden * kElem;     // q of one token
  static constexpr int kKVBytes = 2 * kQBytes;        // k and v of one token
  // padded rows: each row starts 4 banks after the one before
  static constexpr int kQPitch = kQBytes + 16;
  static constexpr int kKVPitch = kKVBytes + 16;
  static constexpr int kQStage = kSub * kQPitch;
  static constexpr int kKVStage = kSub * kKVPitch;
  static constexpr int kStats = kBf16 ? 0 : 3 * kHidden * 4;  // float32: running m, l, rescale
  static constexpr int kCtx = kBf16 ? kHeads * kDh * kCtxPitch * 2 : kHeads * kDh * kDh * 4;
  static constexpr int kChunkSmem = 2 * kKVStage + kStats + kCtx;
  static constexpr int kOutSmem = 2 * kQStage + kCtx;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

// d += a b: a 16 x 16 (row-major fragment), b 16 x 8, bf16; d float32
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed: lanes 8i..8i+7 give matrix i's rows
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// kSub token rows from t0 of one item's qkv, `bytes` from byte column
// `col`, into smem rows of `pitch` bytes; rows at or past t_end zero-filled
__device__ __forceinline__ void stage_rows(uint32_t dst, int pitch, const char* item, int in_row,
                                           int col, int bytes, int t0, int t_end) {
  const int per_row = bytes / 16;
  for (int i = threadIdx.x; i < kSub * per_row; i += kThreads) {
    const int r = i / per_row, ch = i - r * per_row;
    const bool ok = t0 + r < t_end;
    const char* src = item + static_cast<size_t>(ok ? t0 + r : t0) * in_row + col + ch * 16;
    cp_async_16(dst + r * pitch + ch * 16, src, ok);
  }
}

// Tokens [t_begin, t_end) in steps of kSub: step s + 1 is staged into the
// other buffer while `body(slot, t0)` works on step s.
template <class Stage, class Body>
__device__ __forceinline__ void pipeline(int t_begin, int t_end, uint32_t buf, int stage_bytes,
                                         Stage stage, Body body) {
  const int steps = (t_end - t_begin + kSub - 1) / kSub;
  stage(buf, t_begin);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int t0 = t_begin + s * kSub;
    if (s + 1 < steps) stage(buf + ((s + 1) & 1) * stage_bytes, t0 + kSub);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    body(s & 1, t0);
    __syncthreads();
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// bf16, k^T v over the chunk on the tensor cores.  Warp w takes head w / 2
// and the 16 channels d of k from 16 (w % 2) as the M rows: its thread
// (g, q4) = (lane / 4, lane % 4) holds rows g -> d0 = 16 (w % 2) + 2g and
// g + 8 -> d0 + 1, so one 32-bit load brings both.  The K dimension is
// the tokens; v is the B operand, read by ldmatrix.trans.  Writes the
// partial (part != nullptr) or the normalised ctx, transposed, as bf16.
__device__ void kv_bf16(unsigned char* smem, const char* item, int t_begin, int t_end,
                        float* part, unsigned char* ctx_s) {
  using L = Layout<true>;
  const uint32_t buf = smem_u32(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int h = warp >> 1, d0 = 16 * (warp & 1) + 2 * g;
  const int kcol = (h * kDh + d0) * 2, vcol = kHidden * 2 + h * kDh * 2;
  float acc[4][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  pipeline(
      t_begin, t_end, buf, L::kKVStage,
      [&](uint32_t dst, int t0) {
        stage_rows(dst, L::kKVPitch, item, L::kInRow, L::kQBytes, L::kKVBytes, t0, t_end);
      },
      [&](int slot, int t0) {
        const unsigned char* rows = smem + slot * L::kKVStage;
        float2 k[2][4];  // tokens 16 ks + 2 q4 + {0, 1, 8, 9}; (.x, .y) = channels d0, d0 + 1
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = 16 * ks + 2 * q4 + (j & 1) + 8 * (j >> 1);
            k[ks][j] = t0 + r < t_end
                           ? unpack_bf16(*reinterpret_cast<const uint32_t*>(rows + r * L::kKVPitch + kcol))
                           : make_float2(-INFINITY, -INFINITY);
            mx0 = fmaxf(mx0, k[ks][j].x);
            mx1 = fmaxf(mx1, k[ks][j].y);
          }
        const float mn0 = fmaxf(m[0], quad_max(mx0)), mn1 = fmaxf(m[1], quad_max(mx1));
        const float s0 = __expf(m[0] - mn0), s1 = __expf(m[1] - mn1);
        m[0] = mn0;
        m[1] = mn1;
        l[0] *= s0;
        l[1] *= s1;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[nt][0] *= s0;
          acc[nt][1] *= s0;
          acc[nt][2] *= s1;
          acc[nt][3] *= s1;
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          float2 p[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j] = make_float2(__expf(k[ks][j].x - mn0), __expf(k[ks][j].y - mn1));
            l[0] += p[j].x;
            l[1] += p[j].y;
          }
          const uint32_t a[4] = {pack_bf16(p[0].x, p[1].x), pack_bf16(p[0].y, p[1].y),
                                 pack_bf16(p[2].x, p[3].x), pack_bf16(p[2].y, p[3].y)};
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, buf + slot * L::kKVStage + (16 * ks + (lane & 15)) * L::kKVPitch +
                                     vcol + (16 * pp + 8 * (lane >> 4)) * 2);
            mma_16816(acc[2 * pp], a, b[0], b[1]);
            mma_16816(acc[2 * pp + 1], a, b[2], b[3]);
          }
        }
      });
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if (part != nullptr) {
    float* p = part + h * kPart;
    if (q4 == 0) {
      p[d0] = m[0];
      p[d0 + 1] = m[1];
      p[kDh + d0] = l[0];
      p[kDh + d0 + 1] = l[1];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* row = p + 2 * kDh + d0 * kDh + 8 * nt + 2 * q4;
      *reinterpret_cast<float2*>(row) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(row + kDh) = make_float2(acc[nt][2], acc[nt][3]);
    }
  } else {
    uint32_t* ct = reinterpret_cast<uint32_t*>(ctx_s);  // [h][e][kCtxPitch] bf16
    const float i0 = 1.f / l[0], i1 = 1.f / l[1];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int e = h * kDh + 8 * nt + 2 * q4;
      ct[(e * kCtxPitch + d0) / 2] = pack_bf16(acc[nt][0] * i0, acc[nt][2] * i1);
      ct[((e + 1) * kCtxPitch + d0) / 2] = pack_bf16(acc[nt][1] * i0, acc[nt][3] * i1);
    }
  }
}

// bf16, out = softmax_d(q) * scale . ctx on the tensor cores.  Warp w takes
// head w / 2 and tokens 16 (w % 2) .. + 15 of each staged step as the M
// rows; the quad of a row holds its 32 q channels, so q's softmax is taken
// in the A fragment's registers.  ctx_s: ctx^T [h][e][kCtxPitch] bf16.
__device__ void out_bf16(unsigned char* smem, const char* item, int t_begin, int t_end,
                         const unsigned char* ctx_s, __nv_bfloat16* out, float scale) {
  using L = Layout<true>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int h = warp >> 1, r0 = 16 * (warp & 1);
  const uint32_t* ct = reinterpret_cast<const uint32_t*>(ctx_s);
  pipeline(
      t_begin, t_end, smem_u32(smem), L::kQStage,
      [&](uint32_t dst, int t0) {
        stage_rows(dst, L::kQPitch, item, L::kInRow, 0, L::kQBytes, t0, t_end);
      },
      [&](int slot, int t0) {
        const unsigned char* rows = smem + slot * L::kQStage;
        float2 q[2][4];  // rows g, g + 8; channels 8 j + 2 q4, + 1
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            q[i][j] = unpack_bf16(*reinterpret_cast<const uint32_t*>(
                rows + (r0 + g + 8 * i) * L::kQPitch + (h * kDh + 8 * j + 2 * q4) * 2));
            mx = fmaxf(mx, fmaxf(q[i][j].x, q[i][j].y));
          }
          mx = quad_max(mx);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            q[i][j] = make_float2(__expf(q[i][j].x - mx), __expf(q[i][j].y - mx));
            sum += q[i][j].x + q[i][j].y;
          }
          const float f = scale / quad_sum(sum);
#pragma unroll
          for (int j = 0; j < 4; ++j) q[i][j] = make_float2(q[i][j].x * f, q[i][j].y * f);
        }
        uint32_t a[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          a[ks][0] = pack_bf16(q[0][2 * ks].x, q[0][2 * ks].y);
          a[ks][1] = pack_bf16(q[1][2 * ks].x, q[1][2 * ks].y);
          a[ks][2] = pack_bf16(q[0][2 * ks + 1].x, q[0][2 * ks + 1].y);
          a[ks][3] = pack_bf16(q[1][2 * ks + 1].x, q[1][2 * ks + 1].y);
        }
        const int t = t0 + r0 + g;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float o[4] = {0.f, 0.f, 0.f, 0.f};
          const int e = h * kDh + 8 * nt + g;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            mma_16816(o, a[ks], ct[(e * kCtxPitch + 16 * ks + 2 * q4) / 2],
                      ct[(e * kCtxPitch + 16 * ks + 8 + 2 * q4) / 2]);
          const int col = h * kDh + 8 * nt + 2 * q4;
          if (t < t_end)
            *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(t) * kHidden + col) = pack_bf16(o[0], o[1]);
          if (t + 8 < t_end)
            *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(t + 8) * kHidden + col) =
                pack_bf16(o[2], o[3]);
        }
      });
}

// float32, k^T v over the chunk on the CUDA cores.  k's column softmax:
// two threads a column (h, d), every other token; the contraction: thread
// (h, d4, e4) accumulates a 4 x 4 tile of ctx[d4 .. d4+3][e4 .. e4+3].
__device__ void kv_f32(unsigned char* smem, const char* item, int t_begin, int t_end, float* part,
                       unsigned char* ctx_s) {
  using L = Layout<false>;
  constexpr int kPitch = L::kKVPitch / 4;
  float* s_m = reinterpret_cast<float*>(smem + 2 * L::kKVStage);
  float* s_l = s_m + kHidden;
  float* s_sc = s_l + kHidden;
  const int tid = threadIdx.x;
  const int col = tid >> 1, half = tid & 1;
  const int h = tid >> 6, d4 = 4 * ((tid >> 3) & 7), e4 = 4 * (tid & 7);
  if (tid < kHidden) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  float acc[4][4] = {};
  pipeline(
      t_begin, t_end, smem_u32(smem), L::kKVStage,
      [&](uint32_t dst, int t0) {
        stage_rows(dst, L::kKVPitch, item, L::kInRow, L::kQBytes, L::kKVBytes, t0, t_end);
      },
      [&](int slot, int t0) {
        float* rows = reinterpret_cast<float*>(smem + slot * L::kKVStage);
        // the even thread of the pair alone reads and writes the column's stats
        const float m_old = __shfl_sync(kFull, half ? 0.f : s_m[col], (tid & 31) & ~1);
        float mx = -INFINITY;
        for (int r = half; r < kSub; r += 2)
          if (t0 + r < t_end) mx = fmaxf(mx, rows[r * kPitch + col]);
        const float mn = fmaxf(m_old, fmaxf(mx, __shfl_xor_sync(kFull, mx, 1)));
        float sum = 0.f;
        for (int r = half; r < kSub; r += 2) {
          float& k = rows[r * kPitch + col];
          const float p = t0 + r < t_end ? expf(k - mn) : 0.f;  // v is zero there too
          k = p;
          sum += p;
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        if (!half) {
          const float sc = expf(m_old - mn);
          s_m[col] = mn;
          s_l[col] = s_l[col] * sc + sum;
          s_sc[col] = sc;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sc = s_sc[h * kDh + d4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] *= sc;
        }
        for (int r = 0; r < kSub; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(rows + r * kPitch + h * kDh + d4);
          const float4 v = *reinterpret_cast<const float4*>(rows + r * kPitch + kHidden + h * kDh + e4);
          const float pv[4] = {p.x, p.y, p.z, p.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
        }
      });
  if (part != nullptr) {
    if (tid < kHidden) {
      part[(tid >> 5) * kPart + (tid & 31)] = s_m[tid];
      part[(tid >> 5) * kPart + kDh + (tid & 31)] = s_l[tid];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(part + h * kPart + 2 * kDh + (d4 + i) * kDh + e4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  } else {
    float* cs = reinterpret_cast<float*>(ctx_s);  // [h][d][e]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float inv = 1.f / s_l[h * kDh + d4 + i];
      *reinterpret_cast<float4*>(cs + (h * kDh + d4 + i) * kDh + e4) =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    }
  }
}

// float32, out = softmax_d(q) * scale . ctx: two threads a (token, head)
// row for the softmax, then thread (h, tg, e4) a 4 x 4 tile of tokens
// tg + 8 i and channels e4 .. e4+3.  ctx_s: ctx [h][d][e] float32.
__device__ void out_f32(unsigned char* smem, const char* item, int t_begin, int t_end,
                        const unsigned char* ctx_s, float* out, float scale) {
  using L = Layout<false>;
  constexpr int kPitch = L::kQPitch / 4;
  const float* cs = reinterpret_cast<const float*>(ctx_s);
  const int tid = threadIdx.x;
  const int h = tid >> 6, tg = (tid >> 3) & 7, e4 = 4 * (tid & 7);
  pipeline(
      t_begin, t_end, smem_u32(smem), L::kQStage,
      [&](uint32_t dst, int t0) {
        stage_rows(dst, L::kQPitch, item, L::kInRow, 0, L::kQBytes, t0, t_end);
      },
      [&](int slot, int t0) {
        float* rows = reinterpret_cast<float*>(smem + slot * L::kQStage);
        {
          const int row = tid >> 1, half = tid & 1;
          float* x = rows + (row >> 2) * kPitch + (row & 3) * kDh + 16 * half;
          float mx = -INFINITY;
#pragma unroll
          for (int i = 0; i < 16; ++i) mx = fmaxf(mx, x[i]);
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            x[i] = expf(x[i] - mx);
            sum += x[i];
          }
          const float f = scale / (sum + __shfl_xor_sync(kFull, sum, 1));
#pragma unroll
          for (int i = 0; i < 16; ++i) x[i] *= f;
        }
        __syncthreads();
        float acc[4][4] = {};
        for (int d = 0; d < kDh; ++d) {
          const float4 c = *reinterpret_cast<const float4*>(cs + (h * kDh + d) * kDh + e4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float qv = rows[(tg + 8 * i) * kPitch + h * kDh + d];
            acc[i][0] = fmaf(qv, c.x, acc[i][0]);
            acc[i][1] = fmaf(qv, c.y, acc[i][1]);
            acc[i][2] = fmaf(qv, c.z, acc[i][2]);
            acc[i][3] = fmaf(qv, c.w, acc[i][3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + tg + 8 * i;
          if (t < t_end)
            *reinterpret_cast<float4*>(out + static_cast<size_t>(t) * kHidden + h * kDh + e4) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      });
}

// One block per (item, chunk).  part: (B, chunks, heads, kPart) float32,
// or nullptr when chunks == 1: then the block also writes out.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
la_chunk_kernel(const void* __restrict__ qkv, float* __restrict__ part, void* __restrict__ out,
                int n, int chunk_len, int chunks, float scale) {
  using L = Layout<kBf16>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int item = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int t_begin = c * chunk_len, t_end = min(n, t_begin + chunk_len);
  const char* base = static_cast<const char*>(qkv) + static_cast<size_t>(item) * n * L::kInRow;
  unsigned char* ctx_s = smem + 2 * L::kKVStage + L::kStats;
  float* part_c = part == nullptr ? nullptr : part + static_cast<size_t>(blockIdx.x) * kHeads * kPart;
  if constexpr (kBf16) {
    kv_bf16(smem, base, t_begin, t_end, part_c, ctx_s);
  } else {
    kv_f32(smem, base, t_begin, t_end, part_c, ctx_s);
  }
  if (part != nullptr) return;
  __syncthreads();  // ctx_s complete
  const size_t row0 = static_cast<size_t>(item) * n;
  if constexpr (kBf16) {
    out_bf16(smem, base, t_begin, t_end, ctx_s, static_cast<__nv_bfloat16*>(out) + row0 * kHidden, scale);
  } else {
    out_f32(smem, base, t_begin, t_end, ctx_s, static_cast<float*>(out) + row0 * kHidden, scale);
  }
}

// One block per (item, head): the chunks' partials merged in chunk order
// into ctx (B, heads, d, e) float32.
__global__ void __launch_bounds__(kThreads)
la_merge_kernel(const float* __restrict__ part, float* __restrict__ ctx, int chunks) {
  __shared__ float coef[kMaxChunks][kDh];
  const int item = blockIdx.x / kHeads, h = blockIdx.x % kHeads;
  const size_t stride = static_cast<size_t>(kHeads) * kPart;  // one chunk to the next
  const float* p0 = part + static_cast<size_t>(item) * chunks * stride + h * kPart;
  if (threadIdx.x < kDh) {
    const int d = threadIdx.x;
    float mx = -INFINITY;
    for (int c = 0; c < chunks; ++c) mx = fmaxf(mx, p0[c * stride + d]);
    float sum = 0.f;
    for (int c = 0; c < chunks; ++c) {
      coef[c][d] = expf(p0[c * stride + d] - mx);
      sum += p0[c * stride + kDh + d] * coef[c][d];
    }
    const float inv = 1.f / sum;
    for (int c = 0; c < chunks; ++c) coef[c][d] *= inv;
  }
  __syncthreads();
  float* dst = ctx + static_cast<size_t>(blockIdx.x) * kDh * kDh;
  for (int i = threadIdx.x; i < kDh * kDh; i += kThreads) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s = fmaf(p0[c * stride + 2 * kDh + i], coef[c][i / kDh], s);
    dst[i] = s;
  }
}

// One block per (item, chunk): q's softmax and q . ctx.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
la_output_kernel(const void* __restrict__ qkv, const float* __restrict__ ctx, void* __restrict__ out,
                 int n, int chunk_len, int chunks, float scale) {
  using L = Layout<kBf16>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int item = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int t_begin = c * chunk_len, t_end = min(n, t_begin + chunk_len);
  const char* base = static_cast<const char*>(qkv) + static_cast<size_t>(item) * n * L::kInRow;
  unsigned char* ctx_s = smem + 2 * L::kQStage;
  const float* src = ctx + static_cast<size_t>(item) * kHeads * kDh * kDh;
  for (int i = threadIdx.x; i < kHeads * kDh * kDh; i += kThreads) {
    if constexpr (kBf16) {  // transposed: [h][e][d]
      const int h = i / (kDh * kDh), d = (i / kDh) % kDh, e = i % kDh;
      reinterpret_cast<__nv_bfloat16*>(ctx_s)[(h * kDh + e) * kCtxPitch + d] = __float2bfloat16_rn(src[i]);
    } else {
      reinterpret_cast<float*>(ctx_s)[i] = src[i];
    }
  }
  // the pipeline's first barrier publishes ctx_s
  const size_t row0 = static_cast<size_t>(item) * n;
  if constexpr (kBf16) {
    out_bf16(smem, base, t_begin, t_end, ctx_s, static_cast<__nv_bfloat16*>(out) + row0 * kHidden, scale);
  } else {
    out_f32(smem, base, t_begin, t_end, ctx_s, static_cast<float*>(out) + row0 * kHidden, scale);
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int blocks, int smem, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// qkv: (B, n, 3 * 4 * 32); tokens [c * chunk_len, (c + 1) * chunk_len) of
// each item are chunk c < chunks = ceil(n / chunk_len) <= 64.  part: (B,
// chunks, 4, 32 + 32 + 32 * 32) float32; with chunks == 1 part is null and
// out (B, n, 4 * 32), same dtype as qkv, is written here.
NOPE_API int nope_la_chunks(const void* qkv, float* part, void* out, int B, int n, int chunk_len,
                            int chunks, float scale, int dtype, void* stream) {
  if (dtype == DT_BF16)
    return launch(la_chunk_kernel<true>, B * chunks, Layout<true>::kChunkSmem, stream, qkv, part, out, n,
                  chunk_len, chunks, scale);
  return launch(la_chunk_kernel<false>, B * chunks, Layout<false>::kChunkSmem, stream, qkv, part, out, n,
                chunk_len, chunks, scale);
}

// part as above -> ctx: (B, 4, 32, 32) float32.
NOPE_API int nope_la_merge(const float* part, float* ctx, int B, int chunks, void* stream) {
  if (chunks > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  return launch(la_merge_kernel, B * kHeads, 0, stream, part, ctx, chunks);
}

// qkv, ctx as above -> out: (B, n, 4 * 32) in qkv's dtype.
NOPE_API int nope_la_output(const void* qkv, const float* ctx, void* out, int B, int n, int chunk_len,
                            int chunks, float scale, int dtype, void* stream) {
  if (dtype == DT_BF16)
    return launch(la_output_kernel<true>, B * chunks, Layout<true>::kOutSmem, stream, qkv, ctx, out, n,
                  chunk_len, chunks, scale);
  return launch(la_output_kernel<false>, B * chunks, Layout<false>::kOutSmem, stream, qkv, ctx, out, n,
                chunk_len, chunks, scale);
}
