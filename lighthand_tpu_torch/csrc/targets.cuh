// MSRA Gaussian targets, shared by heatmap.cu and fused_aug.cu.
//
// Same arithmetic as lighthand_tpu/ops/pallas/heatmap.py:_heatmap_kernel:
// mu = (int)(p / stride + 0.5f) truncates toward zero (not floorf: joints
// may be negative); a joint is dropped iff ul = mu - tmp >= hm or
// br = mu + tmp + 1 < 0 on either axis; support |d| <= tmp;
// value expf(-(dx^2 + dy^2) * inv) with inv = 1 / (2 sigma^2).
//
// lh_write_map writes one joint's whole [hm, hm] map. Only the
// (2 tmp + 1)^2 window around mu can be nonzero (169 of 4096 elements at
// hm = 64, sigma = 2), so the writer stores zeros everywhere else without
// evaluating anything, and evaluates lh_target only for the 4-element row
// pieces that meet the window. dx^2 + dy^2 of these small integers is exact
// in f32, so the window values have the bits of an elementwise evaluation.
#pragma once

#include <stdint.h>

__device__ __forceinline__ int lh_quantize(float p, float stride) {
  return (int)(p / stride + 0.5f);
}

__device__ __forceinline__ int lh_center_valid(int mu_x, int mu_y, int hm,
                                               int tmp) {
  return !((mu_x - tmp >= hm) || (mu_y - tmp >= hm) ||
           (mu_x + tmp + 1 < 0) || (mu_y + tmp + 1 < 0));
}

__device__ __forceinline__ float lh_target(int mu_x, int mu_y, int valid,
                                           int x, int y, int tmp,
                                           float inv) {
  const int dx = x - mu_x;
  const int dy = y - mu_y;
  if (!valid || abs(dx) > tmp || abs(dy) > tmp) return 0.0f;
  const float fx = (float)dx;
  const float fy = (float)dy;
  return expf(-(fx * fx + fy * fy) * inv);
}

// How nthreads threads of the caller (a block, or part of one) cover the
// rows of a [hm, hm] map: thread (tx, ty) writes pieces tx, tx + nx, ... of
// rows ty, ty + ny, ..., so (y, x) come from the loops, with no division per
// element. A piece is a 16-byte float4 when hm % 4 == 0 and the maps are
// 16-byte aligned (vec), one float otherwise.
struct LhMapThreads {
  bool vec;
  int width, tx, ty, nx, ny;  // width: pieces per row
};

__device__ __forceinline__ LhMapThreads lh_map_threads(const float* maps,
                                                       int hm, int tid,
                                                       int nthreads) {
  LhMapThreads t;
  t.vec = (hm & 3) == 0 && ((uintptr_t)maps & 15) == 0;
  t.width = t.vec ? hm >> 2 : hm;
  t.nx = min(t.width, nthreads);
  t.ny = nthreads / t.nx;
  t.tx = tid % t.nx;
  t.ty = tid / t.nx;
  return t;
}

// Writes the [hm, hm] f32 map of the quantised joint (mu_x, mu_y, valid) to
// dst; the threads of t together write every element once.
__device__ __forceinline__ void lh_write_map(float* __restrict__ dst,
                                             int mu_x, int mu_y, int valid,
                                             int hm, int tmp, float inv,
                                             const LhMapThreads& t) {
  if (t.ty >= t.ny) return;
  for (int y = t.ty; y < hm; y += t.ny) {
    const bool row_hit = valid && abs(y - mu_y) <= tmp;
    if (t.vec) {
      float4* row = reinterpret_cast<float4*>(dst + (size_t)y * hm);
      for (int c = t.tx; c < t.width; c += t.nx) {
        const int x0 = c << 2;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row_hit && x0 + 3 >= mu_x - tmp && x0 <= mu_x + tmp) {
          v.x = lh_target(mu_x, mu_y, valid, x0, y, tmp, inv);
          v.y = lh_target(mu_x, mu_y, valid, x0 + 1, y, tmp, inv);
          v.z = lh_target(mu_x, mu_y, valid, x0 + 2, y, tmp, inv);
          v.w = lh_target(mu_x, mu_y, valid, x0 + 3, y, tmp, inv);
        }
        row[c] = v;
      }
    } else {
      float* row = dst + (size_t)y * hm;
      for (int x = t.tx; x < hm; x += t.nx)
        row[x] = row_hit ? lh_target(mu_x, mu_y, valid, x, y, tmp, inv)
                         : 0.0f;
    }
  }
}
