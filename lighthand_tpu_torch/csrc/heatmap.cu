// K2: MSRA heatmap targets, [B, J, 2] f32 joints -> [B, J, hm, hm] f32.
//
// Replaces lighthand_tpu/ops/pallas/heatmap.py:_heatmap_kernel /
// generate_target_batch_pallas (one TPU grid step per sample, the whole
// [J, hm, hm] block in VMEM).
//
// Bound on an H100: writes. At B=128, J=21, hm=64 the output is 44.0 MB
// against 21.5 KB of joints read, and each element costs ~10 operations, so
// the pass is bounded by bytes over the memory rate (13.1 us at 3.35 TB/s).
// Design: one thread per output element, neighbouring threads on
// neighbouring x, so every warp stores 128 contiguous bytes. Each thread
// quantises its joint itself (the 8 bytes it reads sit in L1/L2), so the
// pass is a single launch with no packing step.
#include <cuda_runtime.h>

#include "targets.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void heatmap_targets_kernel(const float* __restrict__ joints,
                                       float* __restrict__ out,
                                       long long n, int hm, float stride,
                                       int tmp, float inv) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const int x = (int)(e % hm);
  const int y = (int)((e / hm) % hm);
  const long long bj = e / ((long long)hm * hm);
  const int mu_x = lh_quantize(joints[2 * bj], stride);
  const int mu_y = lh_quantize(joints[2 * bj + 1], stride);
  const int valid = lh_center_valid(mu_x, mu_y, hm, tmp);
  out[e] = lh_target(mu_x, mu_y, valid, x, y, tmp, inv);
}

}  // namespace

// joints: [BJ, 2] f32 contiguous; out: [BJ, hm, hm] f32 contiguous.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lh_heatmap_targets(const float* joints, float* out, int bj,
                                  int hm, float stride, int tmp, float inv,
                                  void* stream) {
  const long long n = (long long)bj * hm * hm;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  heatmap_targets_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      joints, out, n, hm, stride, tmp, inv);
  return (int)cudaGetLastError();
}
