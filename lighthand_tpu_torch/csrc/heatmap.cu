// K2: MSRA heatmap targets, [B, J, 2+] f32 joints -> [B, J, hm, hm] f32.
//
// Replaces lighthand_tpu/ops/pallas/heatmap.py:_heatmap_kernel /
// generate_target_batch_pallas (one TPU grid step per sample, the whole
// [J, hm, hm] block in VMEM).
//
// Bound on an H100: writes. At B=128, J=21, hm=64 the output is 44.0 MB
// against 21.5 KB of joints read, so the pass is bounded by bytes over the
// memory rate (13.1 us at 3.35 TB/s). Design: one block per (joint, sample)
// map, grid (J, B), so the map comes from the grid with no index
// arithmetic. The block writes its 16 KB map with lh_write_map
// (targets.cuh): 16-byte stores of whole rows, neighbouring threads on
// neighbouring addresses, and the Gaussian evaluated only in the 13x13
// window; the other 96 % of the map is zeros that cost one store each.
// Joints are read through strides, so f32 input of any [B, J, 2+] layout
// with a unit last stride needs no copy.
#include <cuda_runtime.h>

#include "targets.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
heatmap_targets_kernel(const float* __restrict__ joints, long long sb,
                       long long sj, float* __restrict__ out, int hm,
                       float stride, int tmp, float inv) {
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const float* p = joints + b * sb + j * sj;
  const int mu_x = lh_quantize(p[0], stride);
  const int mu_y = lh_quantize(p[1], stride);
  lh_write_map(out + ((size_t)b * gridDim.x + j) * hm * hm, mu_x, mu_y,
               lh_center_valid(mu_x, mu_y, hm, tmp), hm, tmp, inv,
               lh_map_threads(out, hm, threadIdx.x, kThreads));
}

}  // namespace

// joints: [B, J, 2+] f32 with element strides (sb, sj, 1); out: [B, J, hm,
// hm] f32 contiguous. Returns cudaGetLastError() after the launch.
extern "C" int lh_heatmap_targets(const float* joints, long long sb,
                                  long long sj, float* out, int batch,
                                  int njoints, int hm, float stride, int tmp,
                                  float inv, void* stream) {
  if (batch == 0 || njoints == 0 || hm == 0) return 0;
  heatmap_targets_kernel<<<dim3(njoints, batch), kThreads, 0,
                           (cudaStream_t)stream>>>(joints, sb, sj, out, hm,
                                                   stride, tmp, inv);
  return (int)cudaGetLastError();
}
