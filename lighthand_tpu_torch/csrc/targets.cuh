// MSRA Gaussian target value, shared by heatmap.cu and fused_aug.cu.
//
// Same arithmetic as lighthand_tpu/ops/pallas/heatmap.py:_heatmap_kernel:
// mu = (int)(p / stride + 0.5f) truncates toward zero (not floorf: joints
// may be negative); a joint is dropped iff ul = mu - tmp >= hm or
// br = mu + tmp + 1 < 0 on either axis; support |d| <= tmp;
// value expf(-(dx^2 + dy^2) * inv) with inv = 1 / (2 sigma^2).
#pragma once

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
