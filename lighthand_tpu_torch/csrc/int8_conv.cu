// The int8_fwd policy's quantized convolution in two kernels, NHWC:
//
//   lh_quantize_weights: the f32 master weights w [Cout, Cin, kh, kw] (any
//     strides) of a list of convs -> w_q s8 [Cout, kh, kw, Cin], s_w f32
//     [Cout] and the dequantising scale f32 [Cout] of each, one launch for
//     the list (a model's forward quantizes all its convs in one);
//   lh_int8_conv: x bf16 or f32 [N, H, W, Cin], quantized as it is loaded,
//     times w_q -> y [N, Ho, Wo, Cout] = float(sum x_q * w_q) * scale[c],
//     bf16 or f32.
//
// Replaces lighthand_tpu/ops/quant.py:43-59, _quant_forward: the weight
// and activation quantize, and the s8 x s8 -> s32 lax.conv_general_dilated
// (:54) with its epilogue. None of it is a Pallas kernel: the JAX package
// leaves all of it to XLA, which fuses the quantize into the conv's
// producers on the TPU. PyTorch has no int8 convolution on CUDA, so the port
// has these.
//
// Exactness: every operation is JAX's, in f32, as run eagerly:
//   - weights: m = fmaxf(amax |w|, f32(1e-8)); s_w = m / 127.0f, an IEEE
//     division (the build has no fast math); w_q = clamp(rint(w / s_w),
//     +-127); scale = s_w * f32(act_clip / 127). A max is exact in any
//     order.
//   - activations: q = clamp(__float2int_rn(__fmul_rn(float(x), inv)),
//     -127, 127) with inv = f32(1 / (act_clip / 127)). __float2int_rn
//     rounds half to even as jnp.round does and saturates, and the clamp then
//     gives +-127 as jnp.clip does. Padding contributes 0 = quantize(0).
//     NaN activations are outside the contract (jnp.round keeps a NaN that
//     the cast to s8 then leaves undefined).
//   - the sums are int32 (at most 127 * 127 * kh * kw * Cin, under 2^31 for
//     every Cin up to 2048 at 3x3), so any order gives the same integer;
//   - the epilogue: __int2float_rn(acc) * scale[c], rounded once to the
//     output type.
// So the kernels equal their twins in ops/kernels/int8_conv.py bit for bit,
// and through them eager JAX. The s8 activations never reach device memory.
//
// Bound on an H100 (1,979 TOPS int8, 3.35 TB/s): operations where kh * kw *
// Cin is large (ResNet-50's 3x3 256 -> 256 at 16^2, bs32: 9.66 Gop, 4.9 us
// against 2.1 us of bytes), bytes where it is small (HRNet-W32's 3x3 32 ->
// 32 at 64^2: 16.8 MB of bf16 in and out, 5.0 us against 1.2 us of
// operations). The weight kernel is bound by bytes: 5 bytes a weight (f32
// in, s8 out) and 8 a channel; its own note says what its design does.
//
// Design of the conv: an implicit GEMM, M = N*Ho*Wo output pixels by Cout
// channels by K = kh*kw*Cin, that reads each activation once a block.
//   - Main path (int8_conv_wgmma), for Cin a multiple of 32: a block of two
//     warpgroups owns a tile of 128 output pixels of one image (TW, a power
//     of two, by 128 / TW rows; the plan takes the width whose tiles load
//     the fewest input pixels) and BN =
//     32, 64, 128 or 256 channels (shaped to Cout). It walks Cin in chunks
//     of CK = 64 or 32 channels. For each chunk:
//       * the tile's input window (the "halo": (TH - 1) * stride + kh rows
//         by (TW - 1) * stride + kw columns; for a 1x1 conv only the pixels
//         it reads, TH x TW) comes in by 16-byte cp.async,
//         zero-filled outside the image, into a staging buffer in the
//         activations' own type; the block then quantizes it once into an
//         s8 halo whose pixels are padded by 16 bytes, so that the 8 rows of
//         a fragment read start on distinct banks;
//       * B, w_q seen as [Cout, K] K-major, comes in by TMA: one 2-D tile a
//         window tap (CK bytes by BN rows, swizzled over CK bytes; rows past
//         Cout arrive as zeros), all on one mbarrier, into one of two
//         buffers;
//       * for each tap, each thread reads its wgmma A fragment (rows g and
//         g + 8 of its warp's 16, 4 s8 at each of two K offsets) from the
//         halo at the tap's offset, and wgmma.mma_async m64nBNk32 s8.s8.s32
//         takes A from registers and B from shared memory. Two register sets
//         alternate, so that a tap's fragment reads overlap the previous
//         tap's wgmma.
//     The next chunk's halo and B load while a chunk's taps run: a ring of
//     two stages, B in two buffers on two mbarriers. A chunk carries every
//     tap of CK channels, so the nets' convs have 1 to 32 chunks (W32's
//     32 -> 32 3x3 one, ResNet-50's 256 -> 256 3x3 four), and a 3x3 chunk's
//     9 to 18 wgmma cover the next chunk's loads. A third B buffer would
//     not fit at ResNet-50's 3x3 256 -> 256 (72 KiB more on a block of 182
//     KiB), and elsewhere would take the shared memory that lets two blocks
//     share an SM where the grid has more blocks than SMs. Register A
//     was chosen over an s8 A tile for a shared-memory descriptor: a tap's
//     A rows are a shifted window of the halo, which no swizzled wgmma
//     layout describes, and a register fragment is 4 4-byte reads. The
//     output tile goes back through shared memory and out as 16-byte rows
//     of NHWC. Versus im2col rows (an earlier version of this kernel), the
//     halo cuts the bytes a 3x3 conv pulls through L2 by about 9x and
//     quantizes each activation once a block instead of once a tap.
//   - Stem path (int8_conv_stem), for Cin not a multiple of 32 with K = kh *
//     kw * Cin <= 256, at any alignment: both models' stems (Cin 3: 7x7, K
//     = 147, and 3x3, K = 27), whose 6-byte bf16 pixels and 147-byte weight
//     rows neither TMA nor 16-byte cp.async can describe. Bound: bytes, and
//     most of them are the output (ResNet-50's stem at bs32: 12.6 MB in,
//     67.1 MB out, 23.8 us at 3.35 TB/s against 5.0 us of operations). The
//     design keeps every other cost under the stores:
//       * the block's tile is the main path's (128 output pixels of one
//         image, TW x 128 / TW, the same width rule) by BN = 32, 64 or 128
//         channels (Cout rounded up; wider Cout in channel groups);
//       * B, w_q seen as [Cout, K], is read once a block (once a channel
//         group) by the block's own byte loads into shared memory, zero-
//         padded to K_pad = K rounded up to 32 (147 -> 160, 27 -> 32) and
//         laid out as TMA's 32-byte swizzle would lay out K_pad / 32 tiles
//         of BN rows, so b_desc<32> reads it as it reads the main path's
//         32-channel chunks; no new weight layout;
//       * A: the tile's halo (the main path's window, contiguous along
//         each row in NHWC) is read a 4-byte word of s8 at a time (rows
//         padded to whole words): the word's 4 elements are loaded
//         together, zero outside the image, quantized and stored as one
//         word, with one index step a word (faster on the card than a
//         byte at a time, which spent more instructions on indices than
//         on loads). No staging buffer: nothing here is 16-byte aligned. Each thread gathers its wgmma A fragment bytes
//         from the halo through a table of the K offsets (koff: the halo
//         byte of tap (r, s), channel ci, from a pixel's; -1 past K), so
//         the im2col rows are never built: each A byte is read once;
//       * wgmma.mma_async m64nBNk32 s8.s8.s32, two warpgroups of 64 rows,
//         K_pad / 32 steps (5 or 1), A from registers in two alternating
//         sets as on the main path;
//       * the main path's epilogue: staged in shared memory, out as 16-byte
//         rows of NHWC (a pixel's 64 bf16 channels are 128 contiguous
//         bytes);
//       * a persistent grid of as many blocks as fit on the SMs (three of
//         256 threads at BN 64), each walking tiles with the grid's
//         stride. Co-resident blocks overlap one tile's loads with
//         another's wgmma and stores. Two alternatives were slower on the
//         card: a ring that loads the next tile's first three halo words a
//         thread into registers during this tile's wgmma and stores, and
//         four blocks an SM at 64 registers.
//   - Simple path (int8_conv_simple), for the rest: Cin not a multiple of 32
//     with K above 256 (or a stem halo beyond shared memory), or a main-path
//     conv whose operand is not 16-byte aligned, which TMA and cp.async
//     refuse. mma.sync m16n8k32 on 64 x 64 tiles; each thread gathers and
//     quantizes 16 activations and 16 weight bytes a K step. No conv of
//     either model reaches it.
// What still bounds the main path: a chunk's steps run one after another in
// one block (wait for the halo, quantize it, then the taps), so the tensor
// cores idle while a block converts; where the grid has more than one block
// an SM, the plan picks tiles whose shared memory lets two blocks share it,
// so one block's conversion overlaps the other's wgmma. A producer warp and
// two consumer warpgroups in ping-pong, and a persistent grid, are the next
// steps.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

struct Geom {
  int h, w, cin, cout, kh, kw, stride, pad, ho, wo, K;
  long long M;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// JAX's activation quantize: clip(round(x * inv), -127, 127) in f32.
__device__ __forceinline__ int quantize(float x, float inv) {
  return min(max(__float2int_rn(__fmul_rn(x, inv)), -127), 127);
}

__device__ __forceinline__ uint32_t pack4(int q0, int q1, int q2, int q3) {
  return (uint32_t)(q0 & 0xff) | (uint32_t)(q1 & 0xff) << 8 |
         (uint32_t)(q2 & 0xff) << 16 | (uint32_t)(q3 & 0xff) << 24;
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

// ---------------------------------------------------------- simple path

constexpr int kBM = 64;       // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // bytes of K per step: one m16n8k32
constexpr int kRow = 48;      // shared-memory row stride in bytes
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A block of 4 warps owns a 64 x 64 output tile and walks K 32 bytes at a
// time: each thread gathers 16 activations of one pixel's window row (zero
// where the window leaves the image), quantizes them, and gathers 16 weight
// bytes of one output channel; the block stores both to shared memory
// (48-byte rows, so the fragment reads hit 32 distinct banks), and each warp
// runs 2 x 4 mma on its 32 x 32 quarter while the next step's values load.
template <typename InT, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_conv_simple(const InT* __restrict__ x, float inv,
                 const int8_t* __restrict__ w,
                 const float* __restrict__ scale, OutT* __restrict__ out,
                 Geom g) {
  __shared__ __align__(16) uint8_t As[kBM * kRow];
  __shared__ __align__(16) uint8_t Bs[kBN * kRow];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread's loads: row `lr` of each tile, K bytes [16 * half, +16)
  const int lr = tid >> 1;
  const int half = tid & 1;
  const long long m = m0 + lr;
  const bool m_ok = m < g.M;
  int hi0 = 0, wi0 = 0;
  const InT* xb = x;
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

  // The 16 K offsets a thread gathers are consecutive: the window position
  // (rr, ss) and channel ci of the first are divided out once, the rest
  // follow by counting.
  auto load_a = [&](int kt, uint4& v) {
    uint32_t word[4] = {0, 0, 0, 0};
    const int k0 = kt * kBK + half * 16;
    if (m_ok && k0 < g.K) {
      const int rs = k0 / g.cin;
      int ci = k0 - rs * g.cin;
      int rr = rs / g.kw;
      int ss = rs - rr * g.kw;
      for (int i = 0; i < 16 && k0 + i < g.K; ++i) {
        const int hi = hi0 + rr, wi = wi0 + ss;
        if (hi >= 0 && hi < g.h && wi >= 0 && wi < g.w) {
          const int q = quantize(
              to_float(xb[((long long)hi * g.w + wi) * g.cin + ci]), inv);
          word[i >> 2] |= (uint32_t)(q & 0xff) << (8 * (i & 3));
        }
        if (++ci == g.cin) {
          ci = 0;
          if (++ss == g.kw) {
            ss = 0;
            ++rr;
          }
        }
      }
    }
    v = make_uint4(word[0], word[1], word[2], word[3]);
  };

  auto load_b = [&](int kt, uint4& v) {
    uint32_t word[4] = {0, 0, 0, 0};
    if (co_ok) {
      const int k0 = kt * kBK + half * 16;
      for (int i = 0; i < 16 && k0 + i < g.K; ++i)
        word[i >> 2] |= (uint32_t)(uint8_t)wb[k0 + i] << (8 * (i & 3));
    }
    v = make_uint4(word[0], word[1], word[2], word[3]);
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

// ------------------------------------------------------------ main path

constexpr int kWM = 128;        // output pixels a block: two warpgroups
constexpr int kWThreads = 256;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
// at most this much lets two blocks share an SM's 228 KB (1 KB of it
// reserved a block)
constexpr int kSmemTwoBlocks = 233472 / 2 - 1024;

// A block's output tile: TH x TW pixels of one image, TW = 1 << tw_log2
// (at most 128), TH = 128 / TW; and the input window ("halo") it reads: ih
// x iw pixels, `step` input pixels apart (the stride for a 1x1 conv, whose
// halo holds only the pixels it reads; else 1), tile pixels `hstride` halo
// pixels apart (the stride, or 1 for a 1x1 conv).
struct Tile {
  int tw_log2, tiles_h, tiles_w, ih, iw, step, hstride;
};

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void mma(int (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(int (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(int (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ static __forceinline__ void mma(int (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
          "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
          "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// 16 bytes from src, or 16 zeros where ok is false (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to wgmma, which reads
// its shared-memory operands through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The wgmma descriptor of a K-major B tile of rows of CK bytes, swizzled
// over CK bytes (64: layout 2, 32: layout 3): the start address in 16-byte
// units and the stride between 8-row groups; the leading offset is unused
// for a swizzled K-major operand.
template <int CK>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)((8 * CK) >> 4) << 32 | (uint64_t)(CK == 64 ? 2 : 3) << 62;
}

// 8 activations at p, quantized and packed to s8 in channel order.
__device__ __forceinline__ uint2 quant8(const uint8_t* p, float inv, float) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 16);
  return make_uint2(pack4(quantize(a.x, inv), quantize(a.y, inv),
                          quantize(a.z, inv), quantize(a.w, inv)),
                    pack4(quantize(b.x, inv), quantize(b.y, inv),
                          quantize(b.z, inv), quantize(b.w, inv)));
}

__device__ __forceinline__ uint2 quant8(const uint8_t* p, float inv,
                                        __nv_bfloat16) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  __nv_bfloat162 h[4];
  memcpy(h, &u, 16);
  float2 f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(h[i]);
  return make_uint2(pack4(quantize(f[0].x, inv), quantize(f[0].y, inv),
                          quantize(f[1].x, inv), quantize(f[1].y, inv)),
                    pack4(quantize(f[2].x, inv), quantize(f[2].y, inv),
                          quantize(f[3].x, inv), quantize(f[3].y, inv)));
}

// Shared memory of the main path: two chunks of B (every tap), the staged
// activations of one chunk in their own type, their s8 halo (pixels padded
// by 16 bytes, so the 8 rows of a fragment read start on distinct banks),
// two mbarriers, and slack to align B to 1024 bytes for TMA's swizzle.
// The epilogue reuses it for the [128][bn] output tile (rows padded by 8
// values).
template <typename InT, typename OutT>
int halo_smem_bytes(const Geom& g, const Tile& t, int bn, int ck) {
  const int npx = t.ih * t.iw;
  const int main = 2 * g.kh * g.kw * bn * ck + npx * ck * (int)sizeof(InT) +
                   npx * (ck + 16) + 16;
  const int tile = kWM * (bn + 8) * (int)sizeof(OutT);
  return 1024 + (main > tile ? main : tile);
}

// The epilogue of both wgmma paths, two steps with a barrier between them.
// stage_tile: each thread's dequantized pairs (acc[4j], acc[4j+1] at row
// ra, cols 8j + 2tq, +1; acc[4j+2], acc[4j+3] at row rb) into a [128][BN]
// tile in shared memory whose rows are padded so that the 8 rows of a
// store start on distinct banks.
template <typename OutT, int BN>
__device__ __forceinline__ void stage_tile(const int (&acc)[BN / 2],
                                           uint8_t* tile,
                                           const float* __restrict__ scale,
                                           int n0, int cout, int ra, int rb,
                                           int tq) {
  constexpr int kOutRow = (BN + 8) * (int)sizeof(OutT);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * tq;
    const float s0 = col < cout ? scale[col] : 0.f;
    const float s1 = col + 1 < cout ? scale[col + 1] : 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      OutT* d = reinterpret_cast<OutT*>(tile + (hf ? rb : ra) * kOutRow) +
                8 * j + 2 * tq;
      store_pair(d, __int2float_rn(acc[4 * j + 2 * hf]) * s0,
                 __int2float_rn(acc[4 * j + 2 * hf + 1]) * s1, true, true);
    }
  }
}

// store_tile: the staged tile of image n at (oh0, ow0), channels from n0,
// out as whole rows of 16-byte vectors (one pixel's channels are
// contiguous in NHWC), or value by value where a row's end or its
// alignment does not allow it; pixels outside the image are dropped.
template <typename OutT, int BN>
__device__ __forceinline__ void store_tile(const uint8_t* tile,
                                           OutT* __restrict__ out,
                                           const Geom& g, int tw_log2, int n,
                                           int oh0, int ow0, int n0) {
  constexpr int kOutRow = (BN + 8) * (int)sizeof(OutT);
  constexpr int kVecOut = 16 / (int)sizeof(OutT);  // values a 16-byte store
  constexpr int kRowVecs = BN / kVecOut;
  const int TW = 1 << tw_log2;
  const int ncols = min(BN, g.cout - n0);
  const bool vec_ok = g.cout % kVecOut == 0 && ((uintptr_t)out & 15) == 0;
  for (int i = threadIdx.x; i < kWM * kRowVecs; i += kWThreads) {
    const int row = i / kRowVecs, v = i - row * kRowVecs;
    const int oh = oh0 + (row >> tw_log2), ow = ow0 + (row & (TW - 1));
    if (oh >= g.ho || ow >= g.wo || v * kVecOut >= ncols) continue;
    OutT* dst = out + (((long long)n * g.ho + oh) * g.wo + ow) * g.cout +
                n0 + v * kVecOut;
    const uint8_t* src = tile + row * kOutRow + v * 16;
    if (vec_ok) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const OutT* sv = reinterpret_cast<const OutT*>(src);
      for (int e = 0; e < kVecOut && v * kVecOut + e < ncols; ++e)
        dst[e] = sv[e];
    }
  }
}

template <typename InT, typename OutT, int BN, int CK>
__global__ void __launch_bounds__(kWThreads, 1)
int8_conv_wgmma(const __grid_constant__ CUtensorMap wmap,
                const InT* __restrict__ x, float inv,
                const float* __restrict__ scale, OutT* __restrict__ out,
                Geom g, Tile tl) {
  constexpr int kPix = CK + 16;                     // bytes a halo pixel
  constexpr int kStageRow = CK * (int)sizeof(InT);  // bytes a staged pixel
  constexpr int kCpp = kStageRow / 16;  // 16-byte copies a staged pixel
  constexpr int kKs = CK / 32;          // k32 steps a tap
  const int taps = g.kh * g.kw;
  const int npx = tl.ih * tl.iw;
  const int bbytes = taps * BN * CK;
  const int nc = g.cin / CK;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* b_tiles = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* staged = b_tiles + 2 * bbytes;
  uint8_t* halo = staged + npx * kStageRow;
  uint64_t* full = reinterpret_cast<uint64_t*>(halo + npx * kPix);

  const int tid = threadIdx.x;
  const int TW = 1 << tl.tw_log2, TH = kWM >> tl.tw_log2;
  int bx = blockIdx.x;
  const int tw_i = bx % tl.tiles_w;
  bx /= tl.tiles_w;
  const int th_i = bx % tl.tiles_h;
  const int n = bx / tl.tiles_h;
  const int oh0 = th_i * TH, ow0 = tw_i * TW;
  const int ih0 = oh0 * g.stride - g.pad, iw0 = ow0 * g.stride - g.pad;
  const InT* xn = x + (long long)n * g.h * g.w * g.cin;
  const int n0 = blockIdx.y * BN;

  if (tid == 0) {
    mbar_init(smem_addr(&full[0]), 1);
    mbar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Chunk c (channels [c * CK, + CK)): its halo by cp.async into the
  // staging buffer (zeros outside the image), its B tiles (one a tap) by
  // TMA into buffer c % 2, all on one mbarrier. One commit group a call.
  auto load_chunk = [&](int c) {
    if (c < nc) {
      const int c0 = c * CK;
      const uint32_t dst = smem_addr(staged);
      for (int i = tid; i < npx * kCpp; i += kWThreads) {
        const int p = i / kCpp, j = i - p * kCpp;
        const int hy = p / tl.iw, hx = p - hy * tl.iw;
        const int ih = ih0 + hy * tl.step, iw = iw0 + hx * tl.step;
        const bool ok = ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
        const InT* src =
            ok ? xn + ((long long)ih * g.w + iw) * g.cin + c0 +
                     j * (16 / (int)sizeof(InT))
               : x;
        cp_async16(dst + i * 16, src, ok);
      }
      if (tid == 0) {
        const uint32_t bar = smem_addr(&full[c & 1]);
        const uint32_t bdst = smem_addr(b_tiles + (c & 1) * bbytes);
        mbar_expect_tx(bar, bbytes);
        for (int t = 0; t < taps; ++t)
          tma_load_2d(bdst + t * BN * CK, &wmap, t * g.cin + c0, n0, bar);
      }
    }
    cp_async_commit();
  };

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ra = 64 * wg + 16 * warp + gq, rb = ra + 8;  // fragment rows
  auto halo_px = [&](int row) {
    return (row >> tl.tw_log2) * tl.hstride * tl.iw +
           (row & (TW - 1)) * tl.hstride;
  };
  const uint8_t* ha = halo + halo_px(ra) * kPix + 4 * tq;
  const uint8_t* hb = halo + halo_px(rb) * kPix + 4 * tq;

  // Tap t's A fragments: rows ra and rb of the tile at window offset
  // (t / kw, t % kw), 4 channels at 4 tq and at 16 + 4 tq of each k32 step.
  auto load_a = [&](int t, uint32_t (&a)[kKs][4]) {
    const int r = t / g.kw;
    const int off = (r * tl.iw + t - r * g.kw) * kPix;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      a[ks][0] = *reinterpret_cast<const uint32_t*>(ha + off + 32 * ks);
      a[ks][1] = *reinterpret_cast<const uint32_t*>(hb + off + 32 * ks);
      a[ks][2] = *reinterpret_cast<const uint32_t*>(ha + off + 32 * ks + 16);
      a[ks][3] = *reinterpret_cast<const uint32_t*>(hb + off + 32 * ks + 16);
    }
  };
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  auto issue = [&](int t, int c, const uint32_t (&a)[kKs][4]) {
    const uint64_t desc =
        b_desc<CK>(smem_addr(b_tiles + (c & 1) * bbytes + t * BN * CK));
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks)
      Wgmma<BN>::mma(acc, a[ks], desc + 2 * ks);  // 32 bytes of K further
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  load_chunk(0);
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c staged by every thread
    for (int i = tid; i < npx * (CK / 8); i += kWThreads) {
      const int p = i / (CK / 8), j = i - p * (CK / 8);
      *reinterpret_cast<uint2*>(halo + p * kPix + 8 * j) =
          quant8(staged + p * kStageRow + 8 * j * (int)sizeof(InT), inv,
                 InT());
    }
    // The halo is quantized and the staging buffer free; B buffer
    // (c + 1) % 2 was last read by chunk c - 1's wgmma, waited for.
    __syncthreads();
    load_chunk(c + 1);
    mbar_wait(smem_addr(&full[c & 1]), (c >> 1) & 1);

    // Two register sets in turn, so that a tap's fragment reads overlap the
    // previous tap's wgmma: wait_group 1 frees the set two taps back.
    uint32_t a0[kKs][4], a1[kKs][4];
    load_a(0, a0);
    for (int t = 0; t < taps; t += 2) {
      issue(t, c, a0);
      wgmma_wait<1>();
      if (t + 1 < taps) {
        load_a(t + 1, a1);
        issue(t + 1, c, a1);
      }
      wgmma_wait<1>();
      if (t + 2 < taps) load_a(t + 2, a0);
    }
    wgmma_wait<0>();
  }

  // Epilogue through shared memory (free now: every wgmma has completed and
  // every thread is past its last fragment read).
  if (tid == 0) {
    mbar_inval(smem_addr(&full[0]));
    mbar_inval(smem_addr(&full[1]));
  }
  __syncthreads();
  stage_tile<OutT, BN>(acc, b_tiles, scale, n0, g.cout, ra, rb, tq);
  __syncthreads();
  store_tile<OutT, BN>(b_tiles, out, g, tl.tw_log2, n, oh0, ow0, n0);
}

// ------------------------------------------------------------ stem path

constexpr int kStemMaxK = 256;  // K = kh * kw * Cin the stem path takes

// Shared memory of the stem path: B (K_pad / 32 tiles of BN rows of 32
// bytes, at a 1024-byte boundary as the swizzle wants), the output tile,
// the K offset table and the s8 halo (rows padded to whole 4-byte words).
template <typename OutT>
int stem_smem_bytes(const Geom& g, const Tile& t, int bn, int k_pad) {
  return 1024 + bn * k_pad + kWM * (bn + 8) * (int)sizeof(OutT) +
         4 * k_pad + t.ih * ((t.iw * g.cin + 3) & ~3);
}

// The halo bytes at p + o.x, ..., p + o.w (an offset below 0 is past K: a
// zero) packed as one A fragment register.
__device__ __forceinline__ uint32_t gather4(const uint8_t* p, int4 o) {
  return (o.x < 0 ? 0u : (uint32_t)p[o.x]) |
         (o.y < 0 ? 0u : (uint32_t)p[o.y]) << 8 |
         (o.z < 0 ? 0u : (uint32_t)p[o.z]) << 16 |
         (o.w < 0 ? 0u : (uint32_t)p[o.w]) << 24;
}

// A block of two warpgroups walks items (channel group, image, tile) with
// the grid's stride: B once a channel group, then per tile the halo, the
// K_pad / 32 wgmma steps and the epilogue, with two barriers.
template <typename InT, typename OutT, int BN>
__global__ void __launch_bounds__(kWThreads, BN > 64 ? 2 : 3)
int8_conv_stem(const InT* __restrict__ x, float inv,
               const int8_t* __restrict__ w,
               const float* __restrict__ scale, OutT* __restrict__ out,
               Geom g, Tile tl, int n_img, int k_pad) {
  const int nks = k_pad / 32;
  const int row_bytes = tl.iw * g.cin;  // a halo row: iw pixels of Cin
  const int row_words = (row_bytes + 3) / 4;  // the row in shared memory
  const int row_stride = 4 * row_words;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* b_tiles = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* tile = b_tiles + BN * k_pad;
  int* koff =
      reinterpret_cast<int*>(tile + kWM * (BN + 8) * (int)sizeof(OutT));
  uint8_t* halo = reinterpret_cast<uint8_t*>(koff + k_pad);

  const int tid = threadIdx.x;
  const int TW = 1 << tl.tw_log2, TH = kWM >> tl.tw_log2;
  // K offset k = ((r * kw) + s) * Cin + ci: halo byte r * row_stride +
  // s * Cin + ci from the pixel's
  for (int k = tid; k < k_pad; k += kWThreads) {
    int o = -1;
    if (k < g.K) {
      const int rs = k / g.cin, r = rs / g.kw;
      o = r * row_stride + (rs - r * g.kw) * g.cin + k - rs * g.cin;
    }
    koff[k] = o;
  }

  // B of channels [n0, n0 + BN): 4-byte words of w_q rows, zero past Cout
  // and past K; word (row r, K bytes [k, k + 4)) goes to tile k / 32, row
  // r, its 16-byte chunk (k / 16) % 2 swapped where bit 2 of r is set (the
  // layout TMA's 32-byte swizzle gives the main path's chunks).
  auto load_b = [&](int n0) {
    const int words = k_pad / 4;
    for (int i = tid; i < BN * words; i += kWThreads) {
      const int r = i / words, k = 4 * (i - r * words);
      uint32_t word = 0u;
      if (n0 + r < g.cout) {
        const int8_t* src = w + (long long)(n0 + r) * g.K;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < g.K) word |= (uint32_t)(uint8_t)src[k + j] << (8 * j);
      }
      const int chunk = ((k >> 4) ^ (r >> 2)) & 1;
      *reinterpret_cast<uint32_t*>(b_tiles + (k >> 5) * (BN * 32) + r * 32 +
                                   chunk * 16 + (k & 15)) = word;
    }
    fence_proxy_async();
  };

  // The halo of the tile whose window starts at input (ih0, iw0), a
  // 4-byte word at a time: word q is row q / row_words, bytes 4 (q %
  // row_words) .. + 4 of it (past row_bytes: padding, zero). This thread's
  // words are tid, tid + kWThreads, ..., their rows and places stepped
  // without division; a word's 4 loads are in flight together and it is
  // stored as one. Where step is 1 a halo row is the input row's elements
  // [iw0 * Cin, + row_bytes), those between lo and hi inside the image.
  const int q_row0 = tid / row_words, q_col0 = tid - q_row0 * row_words;
  const int d_row = kWThreads / row_words;
  const int d_col = kWThreads - d_row * row_words;
  auto load_halo = [&](const InT* xn, int ih0, int iw0) {
    const int lo = max(0, -iw0) * g.cin;
    const int hi = min(row_bytes, (min(g.w, iw0 + tl.iw) - iw0) * g.cin);
    for (int hy = q_row0, col = q_col0; hy < tl.ih;) {
      const int gy = ih0 + hy * tl.step;
      float v[4];  // zero outside the image: quantize(0) is 0
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = 4 * col + j;
        long long src = -1;
        if (gy >= 0 && gy < g.h) {
          if (tl.step == 1) {
            if (off >= lo && off < hi)
              src = ((long long)gy * g.w + iw0) * g.cin + off;
          } else if (off < row_bytes) {
            // a strided 1x1 conv: halo pixels step input pixels apart
            const int hx = off / g.cin, gx = iw0 + hx * tl.step;
            if (gx >= 0 && gx < g.w)
              src = ((long long)gy * g.w + gx) * g.cin + off - hx * g.cin;
          }
        }
        v[j] = src >= 0 ? to_float(xn[src]) : 0.f;
      }
      *reinterpret_cast<uint32_t*>(halo + hy * row_stride + 4 * col) =
          pack4(quantize(v[0], inv), quantize(v[1], inv),
                quantize(v[2], inv), quantize(v[3], inv));
      col += d_col;
      hy += d_row;
      if (col >= row_words) {
        col -= row_words;
        ++hy;
      }
    }
  };

  // A fragments: rows ra and rb of the tile, K bytes 4 tq.. and 16 + 4 tq..
  // of step ks, gathered from the halo at the rows' pixels
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ra = 64 * wg + 16 * warp + gq, rb = ra + 8;
  auto halo_at = [&](int row) {
    return halo + (row >> tl.tw_log2) * tl.hstride * row_stride +
           (row & (TW - 1)) * tl.hstride * g.cin;
  };
  const uint8_t* ha = halo_at(ra);
  const uint8_t* hb = halo_at(rb);
  auto load_a = [&](int ks, uint32_t (&a)[4]) {
    const int4 lo = *reinterpret_cast<const int4*>(koff + 32 * ks + 4 * tq);
    const int4 hi =
        *reinterpret_cast<const int4*>(koff + 32 * ks + 16 + 4 * tq);
    a[0] = gather4(ha, lo);
    a[1] = gather4(hb, lo);
    a[2] = gather4(ha, hi);
    a[3] = gather4(hb, hi);
  };

  const int per_img = tl.tiles_h * tl.tiles_w;
  const long long tiles = (long long)n_img * per_img;
  const long long items = tiles * ((g.cout + BN - 1) / BN);
  int loaded = -1;  // the channel group whose B is in shared memory
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int grp = (int)(it / tiles);
    const long long t = it - grp * tiles;
    const int n = (int)(t / per_img);
    const int r = (int)(t - (long long)n * per_img);
    const int th_i = r / tl.tiles_w;
    const int oh0 = th_i * TH, ow0 = (r - th_i * tl.tiles_w) * TW;
    const int n0 = grp * BN;
    if (grp != loaded) {  // every wgmma reading B has completed
      load_b(n0);
      loaded = grp;
    }
    load_halo(x + (long long)n * g.h * g.w * g.cin,
              oh0 * g.stride - g.pad, ow0 * g.stride - g.pad);
    __syncthreads();  // B, the table and the halo in place; the tile free

    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    auto issue = [&](int ks, const uint32_t (&a)[4]) {
      const uint64_t desc = b_desc<32>(smem_addr(b_tiles + ks * (BN * 32)));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      Wgmma<BN>::mma(acc, a, desc);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    // two register sets in turn, as on the main path
    uint32_t a0[4], a1[4];
    load_a(0, a0);
    for (int ks = 0; ks < nks; ks += 2) {
      issue(ks, a0);
      wgmma_wait<1>();
      if (ks + 1 < nks) {
        load_a(ks + 1, a1);
        issue(ks + 1, a1);
      }
      wgmma_wait<1>();
      if (ks + 2 < nks) load_a(ks + 2, a0);
    }
    wgmma_wait<0>();
    stage_tile<OutT, BN>(acc, tile, scale, n0, g.cout, ra, rb, tq);
    __syncthreads();  // the tile staged; the halo and B free
    store_tile<OutT, BN>(tile, out, g, tl.tw_log2, n, oh0, ow0, n0);
  }
}

// ------------------------------------------------------- weight quantize
//
// quantize_weights_kernel: the weights of every quantized conv of a
// forward in one launch. Replaces XLA's per-channel weight quantize,
// lighthand_tpu/ops/quant.py:45-47, which the JAX package runs in each
// conv; the function is the same. Bound: bytes, 4 read and 1 written a
// weight and 8 written a channel (HRNet-W32's 28.5 M weights: 142.6 MB,
// 42.6 us at 3.35 TB/s). The per-value IEEE division (about 20
// instructions) costs about as much, so the design keeps copies in flight
// under the arithmetic:
//   - the host (ops/kernels/int8_conv.py:quantize_plan) writes a table: a
//     row a conv (QConv) and a flat list of work items, each some output
//     channels of one conv, about 16 KB of f32 an item (one channel where K
//     = Cin * kh * kw is large, up to 64 where it is small, a conv's
//     channels split evenly), so that the items are even in bytes;
//   - a persistent grid (as many blocks as fit on the SMs at once) walks
//     the items with a stride of the grid. A block stages item i +
//     grid by a 1D TMA bulk copy (cp.async.bulk, completed on an mbarrier)
//     into one of two buffers while it quantizes item i from the other, so
//     every weight is read from device memory once: one output channel's K
//     values are one span in the contiguous and the channels_last layouts;
//   - amax: a warp a channel (or a slice of one where the item has fewer
//     channels than warps), the warp max of the bit patterns of |w| (non-
//     negative floats order as their bits), then a shared-memory atomicMax;
//     a max is exact in any order;
//   - stores: where the staged rows are in w_q's [kh, kw, Cin] order
//     (channels_last masters, 1x1 convs) and K % 16 == 0, a thread
//     quantizes the 4 values of one float4 and four lanes pool their words
//     into one 16-byte store; otherwise (contiguous masters, whose rows are
//     transposed through shared memory, and ragged K) a thread writes
//     16-byte chunks of w_q, its source index set up once a chunk and
//     stepped by counters;
//   - rows the bulk copy cannot take (a source not 16-byte aligned, or K
//     % 4 != 0: the stems' K = 27 and 147) are staged by the block's own
//     loads, float4 where aligned; rows of other strides, or larger than a
//     stage buffer, are read from device memory where they lie (twice).

constexpr int kQThreads = 256;
constexpr int kQWarps = kQThreads / 32;
constexpr int kQMaxCh = 64;            // channels an item
constexpr int kQMaxStage = 96 * 1024;  // bytes a stage buffer
enum QMode { kQBulk = 0, kQLoad = 1, kQGlobal = 2 };

// A conv's row of the table (ops/kernels/int8_conv.py:QCONV packs it).
struct QConv {
  const float* w;            // f32 master weights [cout, cin, kh, kw]
  long long s0, s1, s2, s3;  // their element strides
  long long wq;              // byte offset of w_q [cout, kh, kw, cin]
  int cout, cin, kh, kw;
  int sw;    // offset of s_w in the f32 pool; scale at n_sw + sw
  int cpi;   // channels an item
  int mode;  // QMode
  int flat;  // staged rows in [kh, kw, cin] order and K % 16 == 0
};
static_assert(sizeof(QConv) == 80, "QConv is the table's 80-byte row");

// JAX's weight quantize of one value: clip(round(w / s_w), -127, 127),
// an IEEE division.
__device__ __forceinline__ int quantize_w(float v, float sw) {
  return (int)fminf(fmaxf(rintf(v / sw), -127.0f), 127.0f);
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(kQThreads)
quantize_weights_kernel(const QConv* __restrict__ convs,
                        const int2* __restrict__ items, int n_items,
                        int stage_bytes, float sx, int8_t* __restrict__ wq,
                        float* __restrict__ fpool, int n_sw) {
  extern __shared__ __align__(16) uint8_t q_smem[];
  __shared__ uint64_t bar[2];
  __shared__ unsigned s_amax[kQMaxCh];
  __shared__ float s_sw[kQMaxCh];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* const stage[2] = {reinterpret_cast<float*>(q_smem),
                           reinterpret_cast<float*>(q_smem + stage_bytes)};

  if (tid < kQMaxCh) s_amax[tid] = 0u;
  if (tid == 0) {
    mbar_init(smem_addr(&bar[0]), 1);
    mbar_init(smem_addr(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0: item it's rows by bulk copy into buffer b (bulk items only).
  // The buffer was last read before a __syncthreads; the proxy fence orders
  // those reads before the copy's writes.
  auto issue = [&](int it, int b) {
    const int2 item = items[it];
    const QConv& c = convs[item.x];
    if (c.mode != kQBulk) return;
    const int K = c.cin * c.kh * c.kw;
    const int nch = min(c.cpi, c.cout - item.y);
    const uint32_t row = 4u * K, bar_b = smem_addr(&bar[b]);
    const uint32_t dst = smem_addr(stage[b]);
    const float* src = c.w + item.y * c.s0;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar_b, nch * row);
    if (c.s0 == K) {
      bulk_load(dst, src, nch * row, bar_b);
    } else {
      for (int i = 0; i < nch; ++i)
        bulk_load(dst + i * row, src + i * c.s0, row, bar_b);
    }
  };

  unsigned phase = 0;  // bit b: the parity of buffer b's next completion
  int b = 0;
  if (tid == 0 && (int)blockIdx.x < n_items) issue(blockIdx.x, 0);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x, b ^= 1) {
    if (tid == 0 && it + (int)gridDim.x < n_items)
      issue(it + gridDim.x, b ^ 1);
    const int2 item = items[it];
    const QConv c = convs[item.x];
    const int ch0 = item.y, K = c.cin * c.kh * c.kw;
    const int nch = min(c.cpi, c.cout - ch0);
    const int n = nch * K;  // values (and w_q bytes) of the item
    float* const st = stage[b];
    const float* src = st;  // channel 0 of the item: staged, or in place
    long long chs = K;      // values from one channel's row to the next
    if (c.mode == kQBulk) {
      mbar_wait(smem_addr(&bar[b]), (phase >> b) & 1);
      phase ^= 1u << b;
    } else if (c.mode == kQLoad) {  // dense, adjacent rows (s0 == K)
      const float* g = c.w + ch0 * c.s0;
      if (((uintptr_t)g & 15) == 0 && (n & 3) == 0) {
        for (int i = tid; i < n / 4; i += kQThreads)
          reinterpret_cast<float4*>(st)[i] =
              __ldg(reinterpret_cast<const float4*>(g) + i);
      } else {
        for (int i = tid; i < n; i += kQThreads) st[i] = __ldg(g + i);
      }
      __syncthreads();
    } else {
      src = c.w + ch0 * c.s0;
      chs = c.s0;
    }

    // amax of each channel: warps over (channel, slice) units
    const int parts = nch >= kQWarps ? 1 : kQWarps / nch;
    for (int u = warp; u < nch * parts; u += kQWarps) {
      const int ch = u / parts, part = u - ch * parts;
      unsigned m = 0u;
      if (c.mode != kQGlobal && (K & 3) == 0) {
        const float4* r4 = reinterpret_cast<const float4*>(src + ch * K);
        const int n4 = K / 4;
        const int hi = (part + 1) * n4 / parts;
        for (int j = part * n4 / parts + lane; j < hi; j += 32) {
          const float4 v = r4[j];
          m = max(max(m, max(abs_bits(v.x), abs_bits(v.y))),
                  max(abs_bits(v.z), abs_bits(v.w)));
        }
      } else if (c.mode != kQGlobal) {
        const float* row = src + ch * K;
        const int hi = (part + 1) * K / parts;
        for (int j = part * K / parts + lane; j < hi; j += 32)
          m = max(m, abs_bits(row[j]));
      } else {
        const float* row = src + ch * chs;
        const int hi = (int)((long long)(part + 1) * K / parts);
        for (int k = (int)((long long)part * K / parts) + lane; k < hi;
             k += 32) {
          const int rs = k / c.cin, ci = k - rs * c.cin, r = rs / c.kw;
          m = max(m, abs_bits(__ldg(row + ci * c.s1 + r * c.s2 +
                                    (rs - r * c.kw) * c.s3)));
        }
      }
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0) atomicMax(&s_amax[ch], m);
    }
    __syncthreads();
    if (tid < nch) {
      const float amax = __uint_as_float(s_amax[tid]);
      s_amax[tid] = 0u;
      const float m = fmaxf(amax, 1e-8f);
      const float sw = m / 127.0f;  // IEEE division, as eager JAX divides
      s_sw[tid] = sw;
      fpool[c.sw + ch0 + tid] = sw;
      fpool[n_sw + c.sw + ch0 + tid] = sw * sx;
    }
    __syncthreads();

    // w_q: the item's bytes are one span [lo, lo + n) of the s8 pool
    const long long lo = c.wq + (long long)ch0 * K;
    if (c.flat) {
      // a word of 4 values never straddles a channel; the span is 16-byte
      // aligned (the pool's offsets are multiples of 128)
      const float4* s4 = reinterpret_cast<const float4*>(src);
      uint4* out = reinterpret_cast<uint4*>(wq + lo);
      const float inv_k = 1.0f / (float)K;
      for (int base = warp * 32; base < n / 4; base += kQThreads) {
        const int u = base + lane;
        uint32_t word = 0u;
        if (u < n / 4) {
          int ch = (int)((float)(4 * u) * inv_k);  // then made exact
          if (ch * K > 4 * u)
            --ch;
          else if ((ch + 1) * K <= 4 * u)
            ++ch;
          const float sw = s_sw[ch];
          const float4 v = s4[u];
          word = pack4(quantize_w(v.x, sw), quantize_w(v.y, sw),
                       quantize_w(v.z, sw), quantize_w(v.w, sw));
        }
        const uint32_t w1 = __shfl_down_sync(0xffffffffu, word, 1);
        const uint32_t w2 = __shfl_down_sync(0xffffffffu, word, 2);
        const uint32_t w3 = __shfl_down_sync(0xffffffffu, word, 3);
        if ((lane & 3) == 0 && u < n / 4)
          out[u >> 2] = make_uint4(word, w1, w2, w3);
      }
    } else {
      // 16-byte chunks of the pool that meet the span; a chunk's first
      // value's channel and (r, s, ci) by division, then counters
      for (long long q = (lo >> 4) + tid; q < (lo + n + 15) >> 4;
           q += kQThreads) {
        int e = (int)((q << 4) - lo);  // the chunk's first byte in the span
        const bool whole = e >= 0 && e + 16 <= n;
        const int first = max(e, 0);
        int ch = first / K;
        const int k = first - ch * K;
        const int rs = k / c.cin;
        int ci = k - rs * c.cin, r = rs / c.kw, s = rs - r * c.kw;
        uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i, ++e) {
          if (e < 0 || e >= n) continue;
          const float v = src[ch * chs + ci * c.s1 + r * c.s2 + s * c.s3];
          const int qv = quantize_w(v, s_sw[ch]);
          word[i >> 2] |= (uint32_t)(qv & 0xff) << (8 * (i & 3));
          if (!whole) wq[lo + e] = (int8_t)qv;
          if (++ci == c.cin) {
            ci = 0;
            if (++s == c.kw) {
              s = 0;
              if (++r == c.kh) {
                r = 0;
                ++ch;
              }
            }
          }
        }
        if (whole)
          *reinterpret_cast<uint4*>(wq + (q << 4)) =
              make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
    __syncthreads();  // the stage buffer, s_sw and s_amax free again
  }
}

// --------------------------------------------------------------- launch

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime so that the library
// needs no -lcuda; null where the CUDA installation lacks it.
EncodeTiled encoder() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

int sm_count() {
  static int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 132;
  }();
  return n;
}

// The main path's weights as a TMA map: [Cout rows, K bytes], boxes of ck
// bytes (one tap's chunk of channels) by bn rows, swizzled over ck bytes,
// zeros out of range.
bool weight_map(CUtensorMap* map, const int8_t* w, const Geom& g, int bn,
                int ck) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)g.K, (cuuint64_t)g.cout};
  const cuuint64_t strides[1] = {(cuuint64_t)g.K};
  const cuuint32_t box[2] = {(cuuint32_t)ck, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<int8_t*>(w), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                ck == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How a conv runs: the path; channels a block (bn); the main path's
// channels a chunk, or the stem path's K_pad (ck); the tile.
enum Path { kSimplePath = 0, kWgmmaPath = 1, kStemPath = 2 };
struct Plan {
  int path, bn, ck;
  Tile tile;
  int smem;
};

// The tile of the wgmma paths: the width, a power of two up to the one
// that covers Wo, whose tiles load the fewest input pixels over the image
// (the halo of a 3x3 tile 16 wide is 180 pixels, of one 64 wide 264); the
// wider on a tie. False where the grid would be too large.
bool make_tile(const Geom& g, int n, Tile& t) {
  t.step = g.kh == 1 && g.kw == 1 ? g.stride : 1;
  t.hstride = g.stride / t.step;
  long long least = -1;
  for (int l = 0; l <= 7 && (l == 0 || (1 << (l - 1)) < g.wo); ++l) {
    const int w_ = 1 << l, h_ = kWM / w_;
    const long long loaded = (long long)((g.ho + h_ - 1) / h_) *
                             ((g.wo + w_ - 1) / w_) *
                             ((h_ - 1) * t.hstride + g.kh) *
                             ((w_ - 1) * t.hstride + g.kw);
    if (least < 0 || loaded <= least) {
      least = loaded;
      t.tw_log2 = l;
    }
  }
  const int tw = 1 << t.tw_log2, th = kWM / tw;
  t.tiles_w = (g.wo + tw - 1) / tw;
  t.tiles_h = (g.ho + th - 1) / th;
  t.ih = (th - 1) * t.hstride + g.kh;
  t.iw = (tw - 1) * t.hstride + g.kw;
  return (long long)n * t.tiles_h * t.tiles_w <= 0x7fffffffLL;
}

// The stem path takes Cin not a multiple of 32 with K <= 256, at any
// alignment, where its shared memory fits: channels a block, the power of
// two from 32 to 128 that covers Cout (wider Cout in groups of 128).
// The main path takes Cin a multiple of 32 (whole k32 steps of one tap)
// with both operands 16-byte aligned (cp.async, TMA). Channels a block: the
// power of two from 32 to 256 that covers Cout, halved (not below 64) while
// the grid would leave more than a quarter of the SMs without a block. Then
// the first (bn, ck), bn from there down to 32 and the chunk 64 (where Cin
// allows) before 32, that fits; where the grid has more than one block an
// SM, first the first whose shared memory lets two blocks share an SM (one
// block's loads and conversion then overlap the other's wgmma). The rest
// takes the simple path.
template <typename InT, typename OutT>
Plan plan(const Geom& g, int n, const void* x, const void* w) {
  Plan p{};
  Tile t;
  if (g.cin % 32 != 0) {
    if (g.K > kStemMaxK || !make_tile(g, n, t)) return p;
    int bn = 32;
    while (bn < 128 && bn < g.cout) bn *= 2;
    const int k_pad = (g.K + 31) / 32 * 32;
    const int smem = stem_smem_bytes<OutT>(g, t, bn, k_pad);
    if (smem <= kMaxSmem) p = Plan{kStemPath, bn, k_pad, t, smem};
    return p;
  }
  if ((uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0 || !make_tile(g, n, t))
    return p;
  const long long blocks = (long long)n * t.tiles_h * t.tiles_w;
  int bn0 = 32;
  while (bn0 < 256 && bn0 < g.cout) bn0 *= 2;
  while (bn0 > 64 &&
         blocks * ((g.cout + bn0 - 1) / bn0) * 4 < 3LL * sm_count())
    bn0 /= 2;
  const bool many = blocks * ((g.cout + bn0 - 1) / bn0) > sm_count();
  const int limits[2] = {many ? kSmemTwoBlocks : kMaxSmem, kMaxSmem};
  for (const int limit : limits) {
    for (int bn = bn0; bn >= 32; bn /= 2) {
      for (int ck = g.cin % 64 == 0 ? 64 : 32; ck >= 32; ck /= 2) {
        const int smem = halo_smem_bytes<InT, OutT>(g, t, bn, ck);
        if (smem <= limit) return Plan{kWgmmaPath, bn, ck, t, smem};
      }
    }
  }
  return p;
}

template <typename InT, typename OutT, int BN, int CK>
int launch_wgmma(const InT* x, float inv, const int8_t* w,
                 const float* scale, OutT* out, const Geom& g, int n,
                 const Plan& p, cudaStream_t stream) {
  CUtensorMap map;
  if (!weight_map(&map, w, g, BN, CK)) return (int)cudaErrorInvalidValue;
  auto kernel = int8_conv_wgmma<InT, OutT, BN, CK>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid((unsigned)(n * p.tile.tiles_h * p.tile.tiles_w),
                  (unsigned)((g.cout + BN - 1) / BN));
  kernel<<<grid, kWThreads, p.smem, stream>>>(map, x, inv, scale, out, g,
                                              p.tile);
  return (int)cudaGetLastError();
}

template <typename InT, typename OutT, int BN>
int launch_bn(const InT* x, float inv, const int8_t* w, const float* scale,
              OutT* out, const Geom& g, int n, const Plan& p,
              cudaStream_t stream) {
  return p.ck == 64 ? launch_wgmma<InT, OutT, BN, 64>(x, inv, w, scale, out,
                                                      g, n, p, stream)
                    : launch_wgmma<InT, OutT, BN, 32>(x, inv, w, scale, out,
                                                      g, n, p, stream);
}

// The stem path's persistent grid: as many blocks as fit on the SMs at
// once, at most one an item.
template <typename InT, typename OutT, int BN>
int launch_stem(const InT* x, float inv, const int8_t* w, const float* scale,
                OutT* out, const Geom& g, int n, const Plan& p,
                cudaStream_t stream) {
  auto kernel = int8_conv_stem<InT, OutT, BN>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kWThreads, p.smem);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)n * p.tile.tiles_h * p.tile.tiles_w *
                          ((g.cout + BN - 1) / BN);
  const long long fill = (long long)(per_sm < 1 ? 1 : per_sm) * sm_count();
  kernel<<<(unsigned)(items < fill ? items : fill), kWThreads, p.smem,
           stream>>>(x, inv, w, scale, out, g, p.tile, n, p.ck);
  return (int)cudaGetLastError();
}

template <typename InT, typename OutT>
int launch(const InT* x, float inv, const int8_t* w, const float* scale,
           void* out_, const Geom& g, int n, cudaStream_t stream) {
  OutT* out = static_cast<OutT*>(out_);
  const Plan p = plan<InT, OutT>(g, n, x, w);
  if (p.path == kStemPath) {
    switch (p.bn) {
      case 32:
        return launch_stem<InT, OutT, 32>(x, inv, w, scale, out, g, n, p,
                                          stream);
      case 64:
        return launch_stem<InT, OutT, 64>(x, inv, w, scale, out, g, n, p,
                                          stream);
      default:
        return launch_stem<InT, OutT, 128>(x, inv, w, scale, out, g, n, p,
                                           stream);
    }
  }
  if (p.path == kWgmmaPath) {
    switch (p.bn) {
      case 32:
        return launch_bn<InT, OutT, 32>(x, inv, w, scale, out, g, n, p,
                                        stream);
      case 64:
        return launch_bn<InT, OutT, 64>(x, inv, w, scale, out, g, n, p,
                                        stream);
      case 128:
        return launch_bn<InT, OutT, 128>(x, inv, w, scale, out, g, n, p,
                                         stream);
      default:
        return launch_bn<InT, OutT, 256>(x, inv, w, scale, out, g, n, p,
                                         stream);
    }
  }
  if ((g.cout + kBN - 1) / kBN > 65535 || (g.M + kBM - 1) / kBM > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((g.M + kBM - 1) / kBM),
                  (unsigned)((g.cout + kBN - 1) / kBN));
  int8_conv_simple<InT, OutT><<<grid, kThreads, 0, stream>>>(x, inv, w,
                                                             scale, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, h, w, cin] bf16 (x_f32 == 0) or f32; inv: f32(127 / act_clip);
// w: [cout, kh, kw, cin] s8; scale: [cout] f32; out: [n, ho, wo, cout], f32
// when out_f32 else bf16; all dense. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue (1) for a geometry the kernels do not
// take.
extern "C" int lh_int8_conv(const void* x, int x_f32, float inv,
                            const int8_t* w, const float* scale, void* out,
                            int out_f32, int n, int h, int wd, int cin,
                            int cout, int kh, int kw, int stride, int pad,
                            int ho, int wo, void* stream) {
  Geom g{h, wd, cin, cout, kh, kw, stride, pad, ho, wo, kh * kw * cin,
         (long long)n * ho * wo};
  if (g.M == 0 || cout == 0) return 0;
  if (cin <= 0 || stride <= 0 || pad < 0 || g.K <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_f32) {
    const float* xf = static_cast<const float*>(x);
    return out_f32 ? launch<float, float>(xf, inv, w, scale, out, g, n, s)
                   : launch<float, __nv_bfloat16>(xf, inv, w, scale, out, g,
                                                  n, s);
  }
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  return out_f32
             ? launch<__nv_bfloat16, float>(xb, inv, w, scale, out, g, n, s)
             : launch<__nv_bfloat16, __nv_bfloat16>(xb, inv, w, scale, out, g,
                                                    n, s);
}

// The plan lh_int8_conv follows for these operands: into plan_out, the
// channels a block, the main path's channels a chunk or the stem path's
// K_pad, the tile's width, the shared memory a block (all 0 for the simple
// path) and the path (Path). Returns 0.
extern "C" int lh_int8_conv_plan(const void* x, int x_f32, const void* w,
                                 int out_f32, int n, int h, int wd, int cin,
                                 int cout, int kh, int kw, int stride,
                                 int pad, int ho, int wo, int* plan_out) {
  Geom g{h, wd, cin, cout, kh, kw, stride, pad, ho, wo, kh * kw * cin,
         (long long)n * ho * wo};
  const Plan p = x_f32 ? (out_f32 ? plan<float, float>(g, n, x, w)
                                  : plan<float, __nv_bfloat16>(g, n, x, w))
                       : (out_f32 ? plan<__nv_bfloat16, float>(g, n, x, w)
                                  : plan<__nv_bfloat16, __nv_bfloat16>(
                                        g, n, x, w));
  plan_out[0] = p.bn;
  plan_out[1] = p.ck;
  plan_out[2] = p.path != kSimplePath ? 1 << p.tile.tw_log2 : 0;
  plan_out[3] = p.smem;
  plan_out[4] = p.path;
  return 0;
}

// table: n_convs QConv rows, then (from the next multiple of 16 bytes)
// n_items int2 items (conv, first channel), as ops/kernels/int8_conv.py:
// quantize_plan writes them; stage_bytes: a stage buffer, at most
// kQMaxStage, a multiple of 16; sx: f32(act_clip / 127); w_q: the s8 pool;
// fpool: s_w then scale, n_sw f32 each. Returns cudaGetLastError() after
// the one launch.
extern "C" int lh_quantize_weights(const void* table, int n_convs,
                                   int n_items, int stage_bytes, float sx,
                                   int8_t* w_q, float* fpool, int n_sw,
                                   void* stream) {
  if (n_items == 0) return 0;
  if (n_convs <= 0 || n_items < 0 || stage_bytes < 0 ||
      stage_bytes > kQMaxStage || stage_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const QConv* convs = static_cast<const QConv*>(table);
  const int2* items = reinterpret_cast<const int2*>(
      static_cast<const uint8_t*>(table) +
      (((long long)n_convs * sizeof(QConv) + 15) & ~15LL));
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        quantize_weights_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * kQMaxStage);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int smem = 2 * stage_bytes;
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, quantize_weights_kernel, kQThreads, smem);
  if (e != cudaSuccess) return (int)e;
  // as many blocks as fit on the card at once (five of 256 threads at 48
  // registers), each walking its items
  const long long fill = (long long)(per_sm < 1 ? 1 : per_sm) * sm_count();
  const int blocks = (int)(n_items < fill ? n_items : fill);
  quantize_weights_kernel<<<blocks, kQThreads, smem, (cudaStream_t)stream>>>(
      convs, items, n_items, stage_bytes, sx, w_q, fpool, n_sw);
  return (int)cudaGetLastError();
}
