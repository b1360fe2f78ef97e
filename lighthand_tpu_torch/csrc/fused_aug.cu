// K1: fused u8 image -> (jittered, noised, ImageNet-normalised) image in the
// compute dtype + MSRA heatmap targets, one launch.
//
// Replaces lighthand_tpu/ops/pallas/fused_aug.py:_kernel /
// fused_aug_targets_pallas. Per sample: u8 -> [0,1]; ColorJitter
// (brightness, contrast, saturation, hue via HSV) in the order
// params[5:9], each index clamped to [0, 3] as lax.switch clamps it, gated
// by params[0] as enable*j + (1-enable)*raw; channel noise params[9:12]
// (pre-gated); (p - mean) / std; plus the [J, hm, hm] f32 targets of the
// f32 joints (pixels), quantised here.
//
// Bound on an H100: bytes. At B=128, 256x256: 25.2 MB of u8 read, 50.3 MB
// of bf16 written, 44.0 MB of targets written = 119.5 MB, 35.7 us at
// 3.35 TB/s. Instruction issue and latency come close: the hue op alone
// runs 4 IEEE divisions a pixel, each a refinement with a range check;
// normalize's 3 divide by constants as a multiply and one correction; and
// 8 pixels a thread fill the 64 registers that two blocks of 512 threads
// on an SM leave each thread.
//
// Design. The contrast op blends with the gray mean of the image *as the
// ops before it in that sample's order left it*, a reduction over the
// whole image. One thread-block cluster holds one image (grid (C, B),
// cluster (C, 1, 1); 256x256 is 16 blocks of 512 threads, two blocks to an
// SM); each thread keeps 8 consecutive pixels in registers from load to
// store, so every u8 byte is read once and no op runs twice:
//   - bytes come in as 8-byte loads (bytewise at a ragged or unaligned
//     tail) and turn into floats through a 256-entry table of k / 255.0f,
//     the same bits as the division;
//   - the sample's draws and its target centres (quantised once per map)
//     sit in shared memory;
//   - at each contrast slot the block sums its gray values in a fixed order
//     (per thread, warp shuffles, warps in order) into its shared memory;
//     after a cluster barrier each warp reads the C partials over
//     distributed shared memory, one per lane, and adds them in rank order
//     0..C-1, so all blocks hold the same mean;
//   - the block's share of the target maps (lh_write_map, 16-byte row
//     stores) is written between arriving at the first barrier and waiting
//     on it, which hides the barrier; a sample without contrast writes them
//     while its pixel bytes are in flight;
//   - the result goes out as 16-byte stores straight from registers: 8
//     pixels are 48 bytes of bf16 (96 of f32).
// An image above kMaxCluster * kMaxThreads * kPx pixels (131,072: 384x384
// already is) runs a second instance, fused_aug_groups_kernel: 16 blocks
// whose threads walk several 8-pixel groups each and keep none of them in
// registers across a barrier (see its note). Every image that fits runs
// the register kernel above, unchanged.
// A sample whose enable is exactly 0 skips the chain and the barriers:
// 0 * j + 1 * raw == raw for finite j. A block past the image's last pixel
// still joins every barrier and contributes 0. The cluster's last arrive
// follows its last read of another block's shared memory; the wait for it
// comes just before exit, so no block leaves while its partials are read.
// Numerics follow the JAX kernel: divisions give the bits of IEEE division
// (normalize's through div_std, checked for every numerator on the card),
// the hue modulo is x - floorf(x) (a floor modulo, not fmodf), the store
// rounds to nearest even. Build without --use_fast_math and with --fmad=false, so that no
// multiply-add is contracted where the reference rounds twice.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "targets.cuh"

namespace cg = cooperative_groups;

namespace {

// Mirrored in ops/kernels/fused_aug.py (PX_PER_THREAD, MAX_THREADS,
// MAX_CLUSTER), which computes the launch geometry.
constexpr int kPx = 8;  // consecutive pixels a thread holds
constexpr int kVals = 3 * kPx;
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;  // above 8 needs the non-portable attribute
constexpr int kMaxRounds = 4;    // clamped indices can put contrast in every slot
constexpr int kMapCenters = 32;  // target maps a block quantises up front

__constant__ float kMean[3] = {0.485f, 0.456f, 0.406f};
// The ImageNet std of each channel and its reciprocal, for div_std.
__constant__ float kStd[3] = {0.229f, 0.224f, 0.225f};
__constant__ float kRcpStd[3] = {1.0f / 0.229f, 1.0f / 0.224f,
                                 1.0f / 0.225f};

// a / kStd[c] with r = kRcpStd[c]: q = RN(a r), then one correction
// q + (a - q d) r whose remainder is exact in an FMA (Markstein). Three
// instructions in place of a division's refinement and range check. It
// gives the bits of the division for every numerator normalize passes,
// x - mean for each f32 x in [0, 1] (never subnormal): chip_smoke.py checks
// all of them on the card through lh_count_div_mismatches. Subnormal
// numerators, which it would get wrong, cannot occur here.
__device__ __forceinline__ float div_std(float a, int c) {
  const float d = kStd[c], r = kRcpStd[c];
  const float q = a * r;
  return __fmaf_rn(__fmaf_rn(-q, d, a), r, q);
}

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
  for (int k = 0; k < 4; ++k) a.order[k] = min(max((int)p[5 + k], 0), 3);
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

// Branch-free: a warp's pixels fall in different hue sectors and max
// channels, so both are selected, not branched on. Of rc, gc, bc only the
// two that the reference's h uses are divided out; (0 + bc) - gc == bc - gc
// exactly, so h keeps the reference's bits in all three cases.
__device__ __forceinline__ void hue_shift(float& r, float& g, float& b,
                                          float delta) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float v = maxc;
  const float spread = maxc - minc;
  const float s = maxc > 0.0f ? spread / fmaxf(maxc, 1e-12f) : 0.0f;
  const float safe = fmaxf(spread, 1e-12f);
  // max r: bc - gc; max g: 2 + rc - bc; else 4 + gc - rc
  const bool max_r = maxc == r;
  const bool max_g = !max_r && maxc == g;
  const float off = max_r ? 0.0f : (max_g ? 2.0f : 4.0f);
  const float c1 = max_r ? b : (max_g ? r : g);
  const float c2 = max_r ? g : (max_g ? b : r);
  float h = (off + (maxc - c1) / safe) - (maxc - c2) / safe;
  h = floor_mod1(h / 6.0f);
  if (!(spread > 0.0f)) h = 0.0f;
  h = floor_mod1(h + delta);

  const float i = floorf(h * 6.0f);
  const float f = h * 6.0f - i;
  const float p = v * (1.0f - s);
  const float q = v * (1.0f - s * f);
  const float t = v * (1.0f - s * (1.0f - f));
  // sector k: (v,t,p) (q,v,p) (p,v,t) (p,q,v) (t,p,v) (v,p,q)
  const int k = ((int)i) % 6;
  r = (k == 0 || k == 5) ? v : (k == 1 ? q : (k == 4 ? t : p));
  g = k == 0 ? t : (k <= 2 ? v : (k == 3 ? q : p));
  b = k <= 1 ? p : (k == 2 ? t : (k == 5 ? q : v));
}

// op (clamped): 0 brightness, 1 contrast (with the image's gray mean),
// 2 saturation, 3 hue.
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

// The 3n bytes of a thread's pixels, packed four to a word, zero past them;
// full == (n == kPx).
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ src,
                                           bool full, int n,
                                           uint32_t (&w)[kVals / 4]) {
  if (full && ((uintptr_t)src & 7) == 0) {
    const uint2* s = reinterpret_cast<const uint2*>(src);
#pragma unroll
    for (int k = 0; k < kVals / 8; ++k) {
      const uint2 v = s[k];
      w[2 * k] = v.x;
      w[2 * k + 1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kVals / 4; ++k) w[k] = 0u;
#pragma unroll
  for (int e = 0; e < kVals; ++e)
    if (e < 3 * n) w[e >> 2] |= (uint32_t)src[e] << (8 * (e & 3));
}

__device__ __forceinline__ int byte_at(const uint32_t (&w)[kVals / 4],
                                       int e) {
  return (int)((w[e >> 2] >> (8 * (e & 3))) & 0xffu);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// 16-byte stores of the thread's 3n values when it holds all 8 pixels
// (full) and dst is aligned; scalar stores otherwise.
__device__ __forceinline__ void store_px(__nv_bfloat16* __restrict__ dst,
                                         const float (&v)[kVals], bool full,
                                         int n) {
  if (full && ((uintptr_t)dst & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int k = 0; k < kVals / 8; ++k)
      d[k] = make_uint4(pack_bf16(v[8 * k], v[8 * k + 1]),
                        pack_bf16(v[8 * k + 2], v[8 * k + 3]),
                        pack_bf16(v[8 * k + 4], v[8 * k + 5]),
                        pack_bf16(v[8 * k + 6], v[8 * k + 7]));
    return;
  }
#pragma unroll
  for (int e = 0; e < kVals; ++e)
    if (e < 3 * n) dst[e] = __float2bfloat16_rn(v[e]);
}

__device__ __forceinline__ void store_px(float* __restrict__ dst,
                                         const float (&v)[kVals], bool full,
                                         int n) {
  if (full && ((uintptr_t)dst & 15) == 0) {
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < kVals / 4; ++k)
      d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < kVals; ++e)
    if (e < 3 * n) dst[e] = v[e];
}

// Split cluster barrier: all threads of all blocks of the cluster arrive;
// writes before the arrive are visible to reads after the wait.
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Fixed-order sum over the block: shuffles within each warp, then thread 0
// adds the warps in order. The result is valid in thread 0 only.
__device__ __forceinline__ float block_sum(float acc, float* s_warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = acc;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += s_warp[w];
  return s;
}

template <typename OutT>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_aug_kernel(const uint8_t* __restrict__ img,
                 const float* __restrict__ params,
                 const float* __restrict__ joints, long long jsb,
                 long long jsj, OutT* __restrict__ out,
                 float* __restrict__ targets, int hw, int njoints, int hm,
                 float stride, int tmp, float inv) {
  __shared__ float s_unit[256];
  __shared__ float s_warp[kMaxThreads / 32];
  __shared__ float s_partial[kMaxRounds];
  __shared__ AugParams s_a;
  __shared__ int s_mu[kMapCenters][3];

  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y;
  const int rank = blockIdx.x;  // the cluster spans gridDim.x
  const int nblocks = gridDim.x;
  const int tid = threadIdx.x;

  for (int k = tid; k < 256; k += blockDim.x) s_unit[k] = (float)k / 255.0f;
  if (tid == 0) s_a = load_params(params + 12 * b);
  const AugParams& a = s_a;  // uniform: read from shared memory, not held
  // The block writes maps j = rank + m * nblocks; thread m quantises map m
  // once for all threads (past kMapCenters maps each thread does it).
  if (tid < kMapCenters && rank + tid * nblocks < njoints) {
    const float* p = joints + b * jsb + (rank + tid * nblocks) * jsj;
    s_mu[tid][0] = lh_quantize(p[0], stride);
    s_mu[tid][1] = lh_quantize(p[1], stride);
    s_mu[tid][2] = lh_center_valid(s_mu[tid][0], s_mu[tid][1], hm, tmp);
  }

  const int p0 = (rank * (int)blockDim.x + tid) * kPx;
  // n = clamp(hw - p0, 0, kPx) pixels are this thread's. `full` is its own
  // comparison: nvcc 12.9 compiled `max(0, min(kPx, x)) == kPx` to the
  // predicate of one VIMNMX.RELU, which was also true for 0 <= x < kPx.
  const bool full = p0 + kPx <= hw;
  const int n = full ? kPx : max(hw - p0, 0);
  const size_t base = ((size_t)b * hw + p0) * 3;
  uint32_t w[kVals / 4];
  load_bytes(img + base, full, n, w);
  __syncthreads();  // s_unit, s_a, s_mu

  auto write_targets = [&]() {
    const LhMapThreads t = lh_map_threads(targets, hm, tid, blockDim.x);
    for (int m = 0, j = rank; j < njoints; ++m, j += nblocks) {
      int mu_x, mu_y, valid;
      if (m < kMapCenters) {
        mu_x = s_mu[m][0];
        mu_y = s_mu[m][1];
        valid = s_mu[m][2];
      } else {
        const float* p = joints + b * jsb + j * jsj;
        mu_x = lh_quantize(p[0], stride);
        mu_y = lh_quantize(p[1], stride);
        valid = lh_center_valid(mu_x, mu_y, hm, tmp);
      }
      lh_write_map(targets + ((size_t)b * njoints + j) * hm * hm, mu_x, mu_y,
                   valid, hm, tmp, inv, t);
    }
  };

  const bool jitter = a.enable != 0.0f;
  int rounds = 0;  // contrast slots: the same in every block of the cluster
  if (jitter)
    for (int slot = 0; slot < 4; ++slot) rounds += a.order[slot] == 1;
  // Without a barrier to hide them behind, the target stores go out while
  // the pixel bytes are still on their way.
  if (rounds == 0) write_targets();

  float v[kVals];
#pragma unroll
  for (int e = 0; e < kVals; ++e) v[e] = s_unit[byte_at(w, e)];

  int round = 0;
  if (jitter) {
    for (int slot = 0; slot < 4; ++slot) {
      const int op = a.order[slot];
      float mean = 0.0f;
      if (op == 1) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < kPx; ++i)
          if (i < n) acc += gray_of(v[3 * i], v[3 * i + 1], v[3 * i + 2]);
        const float s = block_sum(acc, s_warp);
        if (tid == 0) s_partial[round] = s;
        cluster_arrive();
        if (round == 0) write_targets();
        cluster_wait();
        // Lane q of every warp fetches block q's partial (one remote load in
        // flight per lane); the lanes then add them in rank order.
        const int lane = tid & 31;
        const float mine =
            lane < nblocks ? *cluster.map_shared_rank(&s_partial[round], lane)
                           : 0.0f;
        float total = 0.0f;
        for (int q = 0; q < nblocks; ++q)
          total += __shfl_sync(0xffffffffu, mine, q);
        mean = total / (float)hw;
        if (++round == rounds) cluster_arrive();  // waited for before exit
      }
#pragma unroll
      for (int i = 0; i < kPx; ++i)
        apply_op(op, v[3 * i], v[3 * i + 1], v[3 * i + 2], a, mean);
    }
  }

  // enable*j + (1-enable)*raw is j itself when enable is 1, and raw (which
  // v still holds) when it is 0: j and raw are finite.
  const bool blend = jitter && a.enable != 1.0f;
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float x = v[3 * i + c];
      if (blend)
        x = a.enable * x + (1.0f - a.enable) * s_unit[byte_at(w, 3 * i + c)];
      x = clip01(x * a.pn[c]);
      v[3 * i + c] = div_std(x - kMean[c], c);
    }
  }
  store_px(out + base, v, full, n);
  if (rounds > 0) cluster_wait();
}

// K1 for an image above the register kernel's capacity. Thread t of block
// r walks the 8-pixel groups q = r * threads + t + i * cluster * threads,
// i < groups, one at a time, and keeps no pixel across a barrier: before
// each contrast round and for the final pass it re-derives a group's values
// from its u8 bytes, replaying the ops of the earlier slots with the means
// of the earlier rounds (in shared memory, the same in every block). So its
// registers are those of one group, and the u8 bytes are read 1 + rounds
// times (the repeats from L2). The per-thread gray sums run over its groups
// in order, then the block and the cluster add them as the register kernel
// does; the mean is the same division by hw.
template <typename OutT>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_aug_groups_kernel(const uint8_t* __restrict__ img,
                        const float* __restrict__ params,
                        const float* __restrict__ joints, long long jsb,
                        long long jsj, OutT* __restrict__ out,
                        float* __restrict__ targets, int hw, int njoints,
                        int hm, float stride, int tmp, float inv,
                        int groups) {
  __shared__ float s_unit[256];
  __shared__ float s_warp[kMaxThreads / 32];
  __shared__ float s_partial[kMaxRounds];
  __shared__ float s_mean[kMaxRounds];
  __shared__ AugParams s_a;
  __shared__ int s_mu[kMapCenters][3];

  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y;
  const int rank = blockIdx.x;
  const int nblocks = gridDim.x;
  const int tid = threadIdx.x;

  for (int k = tid; k < 256; k += blockDim.x) s_unit[k] = (float)k / 255.0f;
  if (tid == 0) s_a = load_params(params + 12 * b);
  const AugParams& a = s_a;
  if (tid < kMapCenters && rank + tid * nblocks < njoints) {
    const float* p = joints + b * jsb + (rank + tid * nblocks) * jsj;
    s_mu[tid][0] = lh_quantize(p[0], stride);
    s_mu[tid][1] = lh_quantize(p[1], stride);
    s_mu[tid][2] = lh_center_valid(s_mu[tid][0], s_mu[tid][1], hm, tmp);
  }
  __syncthreads();  // s_unit, s_a, s_mu

  auto write_targets = [&]() {
    const LhMapThreads t = lh_map_threads(targets, hm, tid, blockDim.x);
    for (int m = 0, j = rank; j < njoints; ++m, j += nblocks) {
      int mu_x, mu_y, valid;
      if (m < kMapCenters) {
        mu_x = s_mu[m][0];
        mu_y = s_mu[m][1];
        valid = s_mu[m][2];
      } else {
        const float* p = joints + b * jsb + j * jsj;
        mu_x = lh_quantize(p[0], stride);
        mu_y = lh_quantize(p[1], stride);
        valid = lh_center_valid(mu_x, mu_y, hm, tmp);
      }
      lh_write_map(targets + ((size_t)b * njoints + j) * hm * hm, mu_x, mu_y,
                   valid, hm, tmp, inv, t);
    }
  };

  const long long first = (long long)rank * blockDim.x + tid;
  const long long span = (long long)nblocks * blockDim.x;
  // Group q's bytes, and its values after the ops of slots [0, upto);
  // returns whether it holds all 8 pixels, and n how many it holds.
  auto derive = [&](long long q, int upto, uint32_t (&w)[kVals / 4],
                    float (&v)[kVals], int& n) {
    const long long p0 = q * kPx;
    const bool full = p0 + kPx <= hw;
    n = full ? kPx : (int)max(hw - p0, 0LL);
    load_bytes(img + ((size_t)b * hw + p0) * 3, full, n, w);
#pragma unroll
    for (int e = 0; e < kVals; ++e) v[e] = s_unit[byte_at(w, e)];
    int r = 0;
    for (int slot = 0; slot < upto; ++slot) {
      const int op = a.order[slot];
      const float mean = op == 1 ? s_mean[r++] : 0.0f;
#pragma unroll
      for (int i = 0; i < kPx; ++i)
        apply_op(op, v[3 * i], v[3 * i + 1], v[3 * i + 2], a, mean);
    }
    return full;
  };

  const bool jitter = a.enable != 0.0f;
  int rounds = 0;
  if (jitter)
    for (int slot = 0; slot < 4; ++slot) rounds += a.order[slot] == 1;
  if (rounds == 0) write_targets();

  int round = 0;
  for (int slot = 0; slot < 4 && round < rounds; ++slot) {
    if (a.order[slot] != 1) continue;
    float acc = 0.0f;
    for (int i = 0; i < groups; ++i) {
      const long long q = first + i * span;
      if (q * kPx >= hw) break;
      uint32_t w[kVals / 4];
      float v[kVals];
      int n;
      derive(q, slot, w, v, n);
#pragma unroll
      for (int k = 0; k < kPx; ++k)
        if (k < n) acc += gray_of(v[3 * k], v[3 * k + 1], v[3 * k + 2]);
    }
    const float s = block_sum(acc, s_warp);
    if (tid == 0) s_partial[round] = s;
    cluster_arrive();
    if (round == 0) write_targets();
    cluster_wait();
    const int lane = tid & 31;
    const float mine =
        lane < nblocks ? *cluster.map_shared_rank(&s_partial[round], lane)
                       : 0.0f;
    float total = 0.0f;
    for (int q = 0; q < nblocks; ++q)
      total += __shfl_sync(0xffffffffu, mine, q);
    if (tid == 0) s_mean[round] = total / (float)hw;
    __syncthreads();  // s_mean[round] before the next derive
    if (++round == rounds) cluster_arrive();  // waited for before exit
  }

  const bool blend = jitter && a.enable != 1.0f;
  for (int i = 0; i < groups; ++i) {
    const long long q = first + i * span;
    if (q * kPx >= hw) break;
    uint32_t w[kVals / 4];
    float v[kVals];
    int n;
    const bool full = derive(q, jitter ? 4 : 0, w, v, n);
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float x = v[3 * k + c];
        if (blend)
          x = a.enable * x +
              (1.0f - a.enable) * s_unit[byte_at(w, 3 * k + c)];
        x = clip01(x * a.pn[c]);
        v[3 * k + c] = div_std(x - kMean[c], c);
      }
    }
    store_px(out + ((size_t)b * hw + q * kPx) * 3, v, full, n);
  }
  if (rounds > 0) cluster_wait();
}

// Counts the f32 x in [0, 1] for which div_std(x - kMean[c], c) and the
// division (x - kMean[c]) / kStd[c] differ in any bit.
__global__ void div_mismatch_kernel(int c,
                                    unsigned long long* __restrict__ bad) {
  const unsigned count = __float_as_uint(1.0f) + 1;  // +0 ... 1
  unsigned long long n = 0;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    const float a = __uint_as_float(i) - kMean[c];
    n += __float_as_uint(div_std(a, c)) != __float_as_uint(a / kStd[c]);
  }
  if (n) atomicAdd(bad, n);
}

// One launch of `kernel` over (cluster, batch) blocks of `threads`, a
// cluster of `cluster` blocks to an image.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int batch, int cluster, int threads,
           cudaStream_t stream, Args... args) {
  if (cluster > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_k1(const uint8_t* img, const float* params, const float* joints,
              long long jsb, long long jsj, OutT* out, float* targets,
              int batch, int hw, int njoints, int hm, float stride, int tmp,
              float inv, int cluster, int threads, int groups,
              cudaStream_t stream) {
  if (groups == 1)
    return launch(fused_aug_kernel<OutT>, batch, cluster, threads, stream,
                  img, params, joints, jsb, jsj, out, targets, hw, njoints,
                  hm, stride, tmp, inv);
  return launch(fused_aug_groups_kernel<OutT>, batch, cluster, threads,
                stream, img, params, joints, jsb, jsj, out, targets, hw,
                njoints, hm, stride, tmp, inv, groups);
}

}  // namespace

// img: [B, H, W, 3] u8 contiguous; params: [B, 12] f32 contiguous; joints:
// [B, J, 2+] f32 with element strides (jsb, jsj, 1); out: [B, H, W, 3] bf16
// (out_bf16 != 0) or f32; targets: [B, J, hm, hm] f32; both contiguous.
// Geometry (ops/kernels/fused_aug.py:launch_geometry): a cluster of
// `cluster` blocks of `threads` threads per image, each thread `groups`
// groups of 8 pixels (1: the register kernel). Returns cudaGetLastError()
// after the one launch, or cudaErrorInvalidValue for a geometry that does
// not cover the image.
extern "C" int lh_fused_aug_targets(const uint8_t* img, const float* params,
                                    const float* joints, long long jsb,
                                    long long jsj, void* out, int out_bf16,
                                    float* targets, int batch, int height,
                                    int width, int njoints, int hm, int tmp,
                                    float inv, float stride, int cluster,
                                    int threads, int groups, void* stream) {
  if (batch == 0) return 0;
  const long long hw = (long long)height * width;
  if (cluster < 1 || cluster > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || batch > 65535 ||
      groups < 1 || hw > 0x7fffffffLL ||
      (long long)cluster * threads * kPx * groups < hw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16)
    return launch_k1(img, params, joints, jsb, jsj, (__nv_bfloat16*)out,
                     targets, batch, (int)hw, njoints, hm, stride, tmp, inv,
                     cluster, threads, groups, s);
  return launch_k1(img, params, joints, jsb, jsj, (float*)out, targets,
                   batch, (int)hw, njoints, hm, stride, tmp, inv, cluster,
                   threads, groups, s);
}

// Adds to *bad, for each channel, the normalize numerators on which
// div_std and IEEE division differ. Returns cudaGetLastError().
extern "C" int lh_count_div_mismatches(unsigned long long* bad,
                                       void* stream) {
  for (int c = 0; c < 3; ++c) {
    div_mismatch_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(c, bad);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
