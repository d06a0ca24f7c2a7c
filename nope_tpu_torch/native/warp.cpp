// Native host-side data plane for nope_tpu.
//
// The input pipeline's per-item hot path — RGBA→RGB alpha compositing
// over black and the virtual-bbox perspective warp
// (cv2.warpPerspective semantics: inverse-mapped bilinear sampling,
// zero border) — implemented in C++ with a std::thread batch pool.
// Replaces the PIL/cv2 per-item Python path in the dataset readers;
// the reference has no native layer at all (its preprocessing is
// per-item Python), so this is new TPU-host performance work, not a
// port.
//
// Build: python -m nope_tpu.native.build   (g++ -O3 -shared -fPIC)
// ABI: plain C functions over contiguous numpy buffers (ctypes).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// dst(x, y) = src(Minv · (x, y, 1)), bilinear, zero border.
// src: H x W x C float32, M: 3x3 row-major *forward* homography
// (src→dst, as produced by getPerspectiveTransform); inverted here in
// double precision.
void warp_perspective_f32(const float* src, int64_t H, int64_t W, int64_t C,
                          const double* M, float* dst, int64_t S) {
  // invert M (3x3, double)
  double a = M[0], b = M[1], c = M[2];
  double d = M[3], e = M[4], f = M[5];
  double g = M[6], h = M[7], i = M[8];
  double det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  double inv[9];
  double id = 1.0 / det;
  inv[0] = (e * i - f * h) * id;
  inv[1] = (c * h - b * i) * id;
  inv[2] = (b * f - c * e) * id;
  inv[3] = (f * g - d * i) * id;
  inv[4] = (a * i - c * g) * id;
  inv[5] = (c * d - a * f) * id;
  inv[6] = (d * h - e * g) * id;
  inv[7] = (b * g - a * h) * id;
  inv[8] = (a * e - b * d) * id;

  for (int64_t y = 0; y < S; ++y) {
    // coordinates in double (homography conditioning), weights in float
    double wy6 = inv[7] * y + inv[8];
    double wy0 = inv[1] * y + inv[2];
    double wy3 = inv[4] * y + inv[5];
    for (int64_t x = 0; x < S; ++x) {
      double w = inv[6] * x + wy6;
      double wr = 1.0 / w;
      double u = (inv[0] * x + wy0) * wr;
      double v = (inv[3] * x + wy3) * wr;
      float* out = dst + (y * S + x) * C;
      double uf = std::floor(u), vf = std::floor(v);
      int64_t u0 = (int64_t)uf, v0 = (int64_t)vf;
      float du = (float)(u - uf), dv = (float)(v - vf);
      // fast path: fully interior bilinear (float math, unrolled C<=4)
      if (u0 >= 0 && u0 + 1 < W && v0 >= 0 && v0 + 1 < H) {
        const float* p00 = src + (v0 * W + u0) * C;
        const float* p10 = p00 + W * C;
        float w00 = (1.f - du) * (1.f - dv), w01 = du * (1.f - dv);
        float w10 = (1.f - du) * dv, w11 = du * dv;
        for (int64_t ch = 0; ch < C; ++ch)
          out[ch] = w00 * p00[ch] + w01 * p00[C + ch] + w10 * p10[ch] +
                    w11 * p10[C + ch];
        continue;
      }
      if (u0 < -1 || u0 >= W || v0 < -1 || v0 >= H) {
        std::memset(out, 0, sizeof(float) * C);
        continue;
      }
      float w00 = (1.f - du) * (1.f - dv), w01 = du * (1.f - dv);
      float w10 = (1.f - du) * dv, w11 = du * dv;
      bool in00 = (u0 >= 0 && u0 < W && v0 >= 0 && v0 < H);
      bool in01 = (u0 + 1 >= 0 && u0 + 1 < W && v0 >= 0 && v0 < H);
      bool in10 = (u0 >= 0 && u0 < W && v0 + 1 >= 0 && v0 + 1 < H);
      bool in11 = (u0 + 1 >= 0 && u0 + 1 < W && v0 + 1 >= 0 && v0 + 1 < H);
      const float* p00 = src + ((v0)*W + u0) * C;
      const float* p01 = p00 + C;
      const float* p10 = p00 + W * C;
      const float* p11 = p10 + C;
      for (int64_t ch = 0; ch < C; ++ch) {
        float acc = 0.f;
        if (in00) acc += w00 * p00[ch];
        if (in01) acc += w01 * p01[ch];
        if (in10) acc += w10 * p10[ch];
        if (in11) acc += w11 * p11[ch];
        out[ch] = acc;
      }
    }
  }
}

// uint8 variant with round-half-away (matching cv2's saturate_cast
// rounding closely enough for image data).
void warp_perspective_u8(const uint8_t* src, int64_t H, int64_t W, int64_t C,
                         const double* M, uint8_t* dst, int64_t S) {
  std::vector<float> srcf(H * W * C);
  for (int64_t k = 0; k < H * W * C; ++k) srcf[k] = (float)src[k];
  std::vector<float> dstf(S * S * C);
  warp_perspective_f32(srcf.data(), H, W, C, M, dstf.data(), S);
  for (int64_t k = 0; k < S * S * C; ++k) {
    float v = dstf[k];
    v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
    dst[k] = (uint8_t)std::lround(v);
  }
}

// RGBA (H, W, 4) uint8 → RGB over black:  rgb * alpha / 255
// (PIL paste-with-mask semantics used by the readers).
void composite_rgba_black(const uint8_t* rgba, int64_t H, int64_t W,
                          uint8_t* rgb) {
  for (int64_t p = 0; p < H * W; ++p) {
    const uint8_t* in = rgba + p * 4;
    uint8_t* out = rgb + p * 3;
    uint16_t a = in[3];
    out[0] = (uint8_t)((in[0] * a + 127) / 255);
    out[1] = (uint8_t)((in[1] * a + 127) / 255);
    out[2] = (uint8_t)((in[2] * a + 127) / 255);
  }
}

// Batched composite+warp+normalize: the full per-item preprocessing in
// one native call.  rgba: (B, H, W, 4) u8; Ms: (B, 3, 3) f64; out:
// (B, S, S, 3) f32 in [-1, 1].  Work split over a thread pool.
void preprocess_batch(const uint8_t* rgba, int64_t B, int64_t H, int64_t W,
                      const double* Ms, float* out, int64_t S,
                      int64_t num_threads) {
  if (num_threads <= 0) {
    num_threads = (int64_t)std::thread::hardware_concurrency();
    if (num_threads <= 0) num_threads = 1;
  }
  num_threads = std::min<int64_t>(num_threads, B);

  auto work = [&](int64_t b0, int64_t b1) {
    std::vector<float> rgbf(H * W * 3);
    std::vector<float> warped(S * S * 3);
    for (int64_t b = b0; b < b1; ++b) {
      const uint8_t* in = rgba + b * H * W * 4;
      for (int64_t p = 0; p < H * W; ++p) {
        float a = in[p * 4 + 3] * (1.0f / 255.0f);
        rgbf[p * 3 + 0] = in[p * 4 + 0] * a;
        rgbf[p * 3 + 1] = in[p * 4 + 1] * a;
        rgbf[p * 3 + 2] = in[p * 4 + 2] * a;
      }
      warp_perspective_f32(rgbf.data(), H, W, 3, Ms + b * 9, warped.data(), S);
      float* o = out + b * S * S * 3;
      for (int64_t k = 0; k < S * S * 3; ++k)
        o[k] = warped[k] * (2.0f / 255.0f) - 1.0f;
    }
  };

  if (num_threads == 1) {
    work(0, B);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (B + num_threads - 1) / num_threads;
  for (int64_t t = 0; t < num_threads; ++t) {
    int64_t b0 = t * chunk, b1 = std::min(B, b0 + chunk);
    if (b0 >= b1) break;
    threads.emplace_back(work, b0, b1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
