// K1: fused u8 image -> (jittered, noised, ImageNet-normalised) image in the
// compute dtype + MSRA heatmap targets.
//
// Replaces lighthand_tpu/ops/pallas/fused_aug.py:_kernel /
// fused_aug_targets_pallas. Per sample: u8 -> [0,1]; ColorJitter
// (brightness, contrast, saturation, hue via HSV) in the order
// params[5:9], gated by params[0] as enable*j + (1-enable)*raw; channel
// noise params[9:12] (pre-gated); (p - mean) / std; plus the [J, hm, hm]
// f32 targets from packed (mu_x, mu_y, valid).
//
// Bound on an H100: bytes. At B=128, 256x256: 25.2 MB of u8 read, 50.3 MB
// of bf16 written, 44.0 MB of targets written = 119.5 MB, 35.7 us at
// 3.35 TB/s. The ~120 f32 operations a pixel needs come to ~15 us at
// 67 TFLOP/s, under the bytes.
//
// Design. The contrast op blends with the gray mean of the image *as
// transformed by the ops before it in that sample's order*, a reduction over
// the whole image. Blocks cannot share it within one launch, and one f32
// image (768 KB) does not fit in a block's shared memory, so there are two
// launches:
//   (a) grid (tiles, B): each block runs the ops that precede contrast on its
//       1024 pixels and writes one partial gray sum to scratch[B, tiles];
//   (b) grid (tiles + target_blocks, B): each pixel block sums its image's
//       partials in a fixed order (deterministic), reruns the whole chain
//       from the u8 input (re-reading 3 bytes a pixel is cheaper than storing
//       12), applies noise and normalize and stores NHWC in the output dtype
//       (no planar transpose); the extra blocks write the targets.
// Numerics follow the JAX kernel: divisions stay divisions, the hue modulo is
// x - floorf(x) (a floor modulo, not fmodf), the store rounds to nearest
// even. Build without --use_fast_math and with --fmad=false, so that no
// multiply-add is contracted where the reference rounds twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "targets.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // pixels (or targets) a block

__constant__ float kMean[3] = {0.485f, 0.456f, 0.406f};
__constant__ float kStd[3] = {0.229f, 0.224f, 0.225f};

struct AugParams {
  float enable, fb, fc, fs, fh;
  int order[4];
  float pn[3];
};

__device__ __forceinline__ AugParams load_params(const float* p) {
  AugParams a;
  a.enable = p[0];
  a.fb = p[1];
  a.fc = p[2];
  a.fs = p[3];
  a.fh = p[4];
  for (int k = 0; k < 4; ++k) a.order[k] = (int)p[5 + k];
  for (int c = 0; c < 3; ++c) a.pn[c] = p[9 + c];
  return a;
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float gray_of(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}

__device__ __forceinline__ float floor_mod1(float x) {
  return x - floorf(x);
}

__device__ void hue_shift(float& r, float& g, float& b, float delta) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float v = maxc;
  const float spread = maxc - minc;
  const float s = maxc > 0.0f ? spread / fmaxf(maxc, 1e-12f) : 0.0f;
  const float safe = fmaxf(spread, 1e-12f);
  const float rc = (maxc - r) / safe;
  const float gc = (maxc - g) / safe;
  const float bc = (maxc - b) / safe;
  float h = maxc == r ? bc - gc
                      : (maxc == g ? 2.0f + rc - bc : 4.0f + gc - rc);
  h = floor_mod1(h / 6.0f);
  if (!(spread > 0.0f)) h = 0.0f;
  h = floor_mod1(h + delta);

  const float i = floorf(h * 6.0f);
  const float f = h * 6.0f - i;
  const float p = v * (1.0f - s);
  const float q = v * (1.0f - s * f);
  const float t = v * (1.0f - s * (1.0f - f));
  switch (((int)i) % 6) {
    case 0: r = v; g = t; b = p; break;
    case 1: r = q; g = v; b = p; break;
    case 2: r = p; g = v; b = t; break;
    case 3: r = p; g = q; b = v; break;
    case 4: r = t; g = p; b = v; break;
    default: r = v; g = p; b = q; break;
  }
}

// op: 0 brightness, 1 contrast (with the image's gray mean), 2 saturation,
// anything else hue (the plain twin selects hue for any other index too).
__device__ __forceinline__ void apply_op(int op, float& r, float& g,
                                         float& b, const AugParams& a,
                                         float mean) {
  if (op == 0) {
    r = clip01(r * a.fb);
    g = clip01(g * a.fb);
    b = clip01(b * a.fb);
  } else if (op == 1) {
    r = clip01(mean + a.fc * (r - mean));
    g = clip01(mean + a.fc * (g - mean));
    b = clip01(mean + a.fc * (b - mean));
  } else if (op == 2) {
    const float gray = gray_of(r, g, b);
    r = clip01(gray + a.fs * (r - gray));
    g = clip01(gray + a.fs * (g - gray));
    b = clip01(gray + a.fs * (b - gray));
  } else {
    hue_shift(r, g, b, a.fh);
  }
}

__device__ __forceinline__ void load_pixel(const uint8_t* src, float& r,
                                           float& g, float& b) {
  r = (float)src[0] / 255.0f;
  g = (float)src[1] / 255.0f;
  b = (float)src[2] / 255.0f;
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// (a) partial gray sums of the image as it enters the contrast op.
__global__ void contrast_partials_kernel(const uint8_t* __restrict__ img,
                                         const float* __restrict__ params,
                                         float* __restrict__ partial,
                                         int hw, int tiles) {
  const int b = blockIdx.y;
  const AugParams a = load_params(params + 12 * b);
  const uint8_t* src = img + (size_t)b * hw * 3;
  float acc = 0.0f;
  for (int k = 0; k < kPerThread; ++k) {
    const int p = blockIdx.x * kTile + k * kThreads + threadIdx.x;
    if (p >= hw) break;
    float r, g, bl;
    load_pixel(src + 3 * (size_t)p, r, g, bl);
    for (int slot = 0; slot < 4 && a.order[slot] != 1; ++slot)
      apply_op(a.order[slot], r, g, bl, a, 0.0f);
    acc += gray_of(r, g, bl);
  }
  // fixed-order block reduction: shuffles within a warp, then warp 0..7
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ float warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    partial[(size_t)b * tiles + blockIdx.x] = s;
  }
}

// (b) the whole chain + store; blocks past the pixel tiles write targets.
template <typename OutT>
__global__ void fused_aug_kernel(const uint8_t* __restrict__ img,
                                 const float* __restrict__ params,
                                 const int* __restrict__ packed,
                                 const float* __restrict__ partial,
                                 OutT* __restrict__ out,
                                 float* __restrict__ targets, int hw,
                                 int tiles, int joints, int hm, int tmp,
                                 float inv) {
  const int b = blockIdx.y;
  if ((int)blockIdx.x >= tiles) {
    const int per_image = joints * hm * hm;
    const int* mu = packed + (size_t)b * joints * 3;
    float* dst = targets + (size_t)b * per_image;
    for (int k = 0; k < kPerThread; ++k) {
      const int e = (blockIdx.x - tiles) * kTile + k * kThreads + threadIdx.x;
      if (e >= per_image) break;
      const int j = e / (hm * hm);
      const int yx = e - j * hm * hm;
      dst[e] = lh_target(mu[3 * j], mu[3 * j + 1], mu[3 * j + 2], yx % hm,
                         yx / hm, tmp, inv);
    }
    return;
  }

  __shared__ float s_mean;
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t) s += partial[(size_t)b * tiles + t];
    s_mean = s / (float)hw;
  }
  __syncthreads();
  const float mean = s_mean;
  const AugParams a = load_params(params + 12 * b);
  const uint8_t* src = img + (size_t)b * hw * 3;
  OutT* dst = out + (size_t)b * hw * 3;
  for (int k = 0; k < kPerThread; ++k) {
    const int p = blockIdx.x * kTile + k * kThreads + threadIdx.x;
    if (p >= hw) break;
    float r0, g0, b0;
    load_pixel(src + 3 * (size_t)p, r0, g0, b0);
    float r = r0, g = g0, bl = b0;
    for (int slot = 0; slot < 4; ++slot)
      apply_op(a.order[slot], r, g, bl, a, mean);
    float c[3] = {a.enable * r + (1.0f - a.enable) * r0,
                  a.enable * g + (1.0f - a.enable) * g0,
                  a.enable * bl + (1.0f - a.enable) * b0};
    for (int ch = 0; ch < 3; ++ch) {
      const float v = clip01(c[ch] * a.pn[ch]);
      store(dst + 3 * (size_t)p + ch, (v - kMean[ch]) / kStd[ch]);
    }
  }
}

}  // namespace

// img: [B, H, W, 3] u8; params: [B, 12] f32; packed: [B, J, 3] i32;
// out: [B, H, W, 3] bf16 (out_bf16 != 0) or f32; targets: [B, J, hm, hm]
// f32; partial: scratch [B, ceil(H*W / 1024)] f32. All contiguous.
// Returns the first nonzero cudaGetLastError() of the two launches.
extern "C" int lh_fused_aug_targets(const uint8_t* img, const float* params,
                                    const int* packed, void* out,
                                    int out_bf16, float* targets,
                                    float* partial, int batch, int height,
                                    int width, int joints, int hm, int tmp,
                                    float inv, void* stream) {
  if (batch == 0) return 0;
  const int hw = height * width;
  const int tiles = (hw + kTile - 1) / kTile;
  const int target_blocks = (joints * hm * hm + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  contrast_partials_kernel<<<dim3(tiles, batch), kThreads, 0, s>>>(
      img, params, partial, hw, tiles);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid(tiles + target_blocks, batch);
  if (out_bf16) {
    fused_aug_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        img, params, packed, partial, (__nv_bfloat16*)out, targets, hw,
        tiles, joints, hm, tmp, inv);
  } else {
    fused_aug_kernel<float><<<grid, kThreads, 0, s>>>(
        img, params, packed, partial, (float*)out, targets, hw, tiles,
        joints, hm, tmp, inv);
  }
  return (int)cudaGetLastError();
}
