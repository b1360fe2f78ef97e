// int8 convolution with a dequantising epilogue, NHWC:
//   x_q s8 [N, H, W, Cin], w_q s8 [Cout, kh, kw, Cin], scale f32 [Cout]
//   -> y [N, Ho, Wo, Cout] = float(sum x_q * w_q) * scale[c], bf16 or f32.
//
// Replaces lighthand_tpu/ops/quant.py:54, the s8 x s8 -> s32
// lax.conv_general_dilated of the int8_fwd policy. That is not a Pallas
// kernel: the JAX package leaves the conv to XLA, which runs it on the TPU's
// matrix unit. PyTorch has no int8 convolution on CUDA, so the port has
// this one.
//
// Exactness: the sums are int32 (at most 127 * 127 * kh * kw * Cin, under
// 2^31 for every Cin up to 2048 at 3x3), so any order of summation gives the
// same integer. The epilogue is the plain twin's and XLA's: int32 -> f32
// with round-to-nearest-even (__int2float_rn), one f32 multiply by the
// per-channel scale (s_w * f32(s_x), computed by the caller), one rounding
// to bf16. The result is equal bit for bit to ops/kernels/int8_conv.py:
// int8_conv2d_plain.
//
// Bound on an H100: at the widths of ResNet-50 and HRNet-W32 (Cin*k*k of
// 64 to 4608) the bytes usually bound it: the bf16 output alone is
// 2 * N * Ho * Wo * Cout bytes against 2 * N * Ho * Wo * Cout * k*k*Cin
// operations, so below k*k*Cin of about 1,200 (1,979 TOPS int8 over
// 3.35 TB/s) the memory, not the tensor cores, sets the least time.
//
// Design (simple first; wgmma with TMA, and the activation quantize fused
// into the load, are later work): an implicit GEMM, M = N*Ho*Wo output
// pixels by Cout channels by K = kh*kw*Cin, on the tensor cores through
// mma.sync.m16n8k32.s8. A block of 4 warps owns a 64 x 64 output tile and
// walks K 32 bytes at a time: each thread gathers 16 bytes of the A tile
// (one pixel's window row, zero where the window leaves the image) and 16
// of the B tile (one output channel's weights) into registers, the block
// stores them to shared memory (48-byte rows, so the fragment reads hit 32
// distinct banks), and each warp runs 2 x 4 mma on its 32 x 32 quarter while
// the next step's bytes load. Cin a multiple of 16 reads 16-byte vectors;
// any other Cin (the stems' 3) gathers bytes one by one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // bytes of K per step: one m16n8k32
constexpr int kRow = 48;      // shared-memory row stride in bytes
constexpr int kThreads = 128;

struct Geom {
  int h, w, cin, cout, kh, kw, stride, pad, ho, wo, K;
  long long M;
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring channels of one pixel: one 4- or 8-byte store where the
// pair is aligned (an even Cout), else one store each.
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0,
                                           float v1, bool has1, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
    return;
  }
  p[0] = __float2bfloat16_rn(v0);
  if (has1) p[1] = __float2bfloat16_rn(v1);
}

__device__ __forceinline__ void store_pair(float* p, float v0, float v1,
                                           bool has1, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    return;
  }
  p[0] = v0;
  if (has1) p[1] = v1;
}

// kVec: Cin % 16 == 0 and both operands 16-byte aligned, so each thread's
// 16 bytes of a K step lie in one (r, s) window position and load as one
// vector. Otherwise the bytes are gathered one by one.
template <bool kVec, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, OutT* __restrict__ out,
                 Geom g) {
  __shared__ __align__(16) uint8_t As[kBM * kRow];
  __shared__ __align__(16) uint8_t Bs[kBN * kRow];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread's loads: row `lr` of each tile, bytes [16 * half, +16)
  const int lr = tid >> 1;
  const int half = tid & 1;
  const long long m = m0 + lr;
  const bool m_ok = m < g.M;
  int hi0 = 0, wi0 = 0;
  const int8_t* xb = x;
  if (m_ok) {
    const long long hw = (long long)g.ho * g.wo;
    const long long img = m / hw;
    const int rem = (int)(m - img * hw);
    const int oh = rem / g.wo;
    const int ow = rem - oh * g.wo;
    hi0 = oh * g.stride - g.pad;
    wi0 = ow * g.stride - g.pad;
    xb = x + img * g.h * g.w * (long long)g.cin;
  }
  const int co = n0 + lr;
  const bool co_ok = co < g.cout;
  const int8_t* wb = w + (long long)(co_ok ? co : 0) * g.K;

  // window position (r, s) and channel c of this thread's next K offset
  int r = 0, s = 0, c = half * 16;
  auto settle = [&]() {
    while (c >= g.cin) {
      c -= g.cin;
      if (++s == g.kw) {
        s = 0;
        ++r;
      }
    }
  };
  if (kVec) settle();

  auto load_a = [&](int kt, uint4& v) {
    v = make_uint4(0, 0, 0, 0);
    if (!m_ok) return;
    if (kVec) {
      const int hi = hi0 + r, wi = wi0 + s;
      if (r < g.kh && hi >= 0 && hi < g.h && wi >= 0 && wi < g.w) {
        v = *reinterpret_cast<const uint4*>(
            xb + ((long long)hi * g.w + wi) * g.cin + c);
      }
    } else {
      uint32_t word[4] = {0, 0, 0, 0};
      const int k0 = kt * kBK + half * 16;
      for (int i = 0; i < 16; ++i) {
        const int k = k0 + i;
        if (k >= g.K) break;
        const int rs = k / g.cin;
        const int ci = k - rs * g.cin;
        const int rr = rs / g.kw;
        const int ss = rs - rr * g.kw;
        const int hi = hi0 + rr, wi = wi0 + ss;
        if (hi >= 0 && hi < g.h && wi >= 0 && wi < g.w) {
          const uint32_t byte = (uint8_t)xb[((long long)hi * g.w + wi) *
                                                g.cin + ci];
          word[i >> 2] |= byte << (8 * (i & 3));
        }
      }
      v = make_uint4(word[0], word[1], word[2], word[3]);
    }
  };

  auto load_b = [&](int kt, uint4& v) {
    v = make_uint4(0, 0, 0, 0);
    if (!co_ok) return;
    const int k0 = kt * kBK + half * 16;
    if (kVec) {
      if (k0 < g.K) v = *reinterpret_cast<const uint4*>(wb + k0);
    } else {
      uint32_t word[4] = {0, 0, 0, 0};
      for (int i = 0; i < 16 && k0 + i < g.K; ++i) {
        word[i >> 2] |= (uint32_t)(uint8_t)wb[k0 + i] << (8 * (i & 3));
      }
      v = make_uint4(word[0], word[1], word[2], word[3]);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gq = lane >> 2, tq = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int nk = (g.K + kBK - 1) / kBK;
  uint4 va, vb;
  load_a(0, va);
  load_b(0, vb);
  for (int kt = 0; kt < nk; ++kt) {
    *reinterpret_cast<uint4*>(As + lr * kRow + half * 16) = va;
    *reinterpret_cast<uint4*>(Bs + lr * kRow + half * 16) = vb;
    __syncthreads();
    if (kt + 1 < nk) {
      if (kVec) {
        c += kBK;
        settle();
      }
      load_a(kt + 1, va);
      load_b(kt + 1, vb);
    }
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* p = As + (wm + i * 16 + gq) * kRow + 4 * tq;
      a[i][0] = *reinterpret_cast<const uint32_t*>(p);
      a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
      a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* p = Bs + (wn + j * 8 + gq) * kRow + 4 * tq;
      b[j][0] = *reinterpret_cast<const uint32_t*>(p);
      b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    __syncthreads();
  }

  // epilogue: c0, c1 at (row gq, cols 2tq, 2tq+1); c2, c3 at row gq + 8
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + j * 8 + 2 * tq;
    if (col >= g.cout) continue;
    const bool has1 = col + 1 < g.cout;
    const bool pair = has1 && g.cout % 2 == 0;
    const float s0 = scale[col];
    const float s1 = has1 ? scale[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long long row = m0 + wm + i * 16 + gq + 8 * hf;
        if (row >= g.M) continue;
        const float v0 = __int2float_rn(acc[i][j][2 * hf]) * s0;
        const float v1 = __int2float_rn(acc[i][j][2 * hf + 1]) * s1;
        store_pair(out + row * g.cout + col, v0, v1, has1, pair);
      }
    }
  }
}

template <typename OutT>
int launch(const int8_t* x, const int8_t* w, const float* scale, void* out,
           const Geom& g, cudaStream_t stream) {
  const dim3 grid((unsigned)((g.M + kBM - 1) / kBM),
                  (unsigned)((g.cout + kBN - 1) / kBN));
  const bool vec = g.cin % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  if (vec) {
    int8_conv_kernel<true, OutT><<<grid, kThreads, 0, stream>>>(
        x, w, scale, static_cast<OutT*>(out), g);
  } else {
    int8_conv_kernel<false, OutT><<<grid, kThreads, 0, stream>>>(
        x, w, scale, static_cast<OutT*>(out), g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, h, w, cin] s8; w: [cout, kh, kw, cin] s8; scale: [cout] f32; out:
// [n, ho, wo, cout], f32 when out_f32 else bf16; all dense. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue (1) for a
// geometry the kernel does not take.
extern "C" int lh_int8_conv(const int8_t* x, const int8_t* w,
                            const float* scale, void* out, int out_f32, int n,
                            int h, int wd, int cin, int cout, int kh, int kw,
                            int stride, int pad, int ho, int wo,
                            void* stream) {
  Geom g{h, wd, cin, cout, kh, kw, stride, pad, ho, wo, kh * kw * cin,
         (long long)n * ho * wo};
  if (g.M == 0 || cout == 0) return 0;
  if (cin <= 0 || stride <= 0 || pad < 0 || g.K <= 0 ||
      (g.cout + kBN - 1) / kBN > 65535 || (g.M + kBM - 1) / kBM > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return out_f32 ? launch<float>(x, w, scale, out, g, s)
                 : launch<__nv_bfloat16>(x, w, scale, out, g, s);
}
