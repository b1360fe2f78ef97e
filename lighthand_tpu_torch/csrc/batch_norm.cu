// BatchNorm (+ an optional fused ReLU, or the end of a residual block) of the
// pose models, in seven kernels over NCHW tensors stored channels_last: x is
// seen as [rows, C] row-major, rows = N*H*W, one channel a column.
//
//   training forward:  lh_bn_fw_partials, lh_bn_fw_finalize, lh_bn_fw_apply
//   training backward: lh_bn_bw_partials, lh_bn_bw_finalize, lh_bn_bw_apply
//   eval forward:      lh_bn_fw_eval (one pass)
//   (eval backward, rare: the three bw kernels with the running statistics)
//
// Replaces no Pallas kernel: the JAX package leaves BatchNorm to XLA (Flax's
// nn.BatchNorm in lighthand_tpu/models/layers.py:ConvBN and
// resnet.py:DeconvBNRelu), which fuses the statistics, the normalisation,
// the casts and the ReLU into its neighbours on the TPU. In PyTorch the same
// layer was a chain of f32 copies, a Welford var_mean, cuDNN's own
// statistics pass, casts back and a separate ReLU: about 60 bytes an element
// moved for forward and backward together.
//
// Bound on an H100: bytes. Per element in bf16: forward reads x for the
// statistics, then reads x and writes y (6 bytes); backward reads dy and x
// for the two sums, then reads them again and writes dx (10 bytes). A few
// f32 operations an element against ~295 the card could do per byte. The
// design moves those 16 bytes and no more:
//   - nothing is staged in device memory but per-channel partials (f32,
//     [splits, C], a few KB): no f32 copy of x, no saved y for a fused ReLU
//     (the backward recomputes its mask from x and the saved mean and
//     invstd with the forward's arithmetic, so the mask is the one the
//     forward's output gives), no separate ReLU pass;
//   - each thread owns 16 bytes of one row (8 bf16 or 4 f32 channels; one
//     element where C or an address does not allow it) and walks rows, so
//     loads are 16-byte vectors, neighbouring threads on neighbouring
//     addresses, and a thread's per-channel parameters stay in registers;
//     each thread issues the loads of 8 rows (4 in the backward, which
//     reads two tensors) before it uses any;
//   - the grid comes from the shape (ops/kernels/batch_norm.py:plan): tiles
//     of channels by splits of rows, as many blocks as the SMs hold at once
//     (from the occupancy the card reports), so both C = 2048 over 2,048
//     rows and C = 32 over 2.1 M rows fill the card in one wave;
//   - statistics in f32 throughout: a thread sums (x - k) and (x - k)^2
//     about its own first value k (a shift inside the data keeps the
//     cancellation small), threads and splits merge by Chan's parallel
//     rule (count, mean, M2), and the variance is the biased one, as Flax
//     keeps it. Outputs are rounded once to the input's type.
//
// The end of a residual block, relu(bn(x) + r), is the apply stage with a
// residual r (a null pointer: none): it reads x and r and writes
// o = relu(T(T(bn(x)) + r)), the rounding order of the chain BN, add, ReLU in
// T, so o is that chain's bit for bit; 6 bytes an element in bf16 where the
// chain moved 14 (y written, then read with r for the sum, which is written
// and read again by the ReLU). Its backward reads o beside dy and x: the gate
// dy' = dy * [o > 0] is threshold_backward's, and the apply stage also writes
// dr = dy', the residual's gradient. The saved o is the next conv's saved
// input already, so the gate keeps no tensor alive that the chain did not.
//
// Every a*b + c below that must repeat exactly between the forward and the
// backward is written with __fmul_rn / __fadd_rn, so no contraction into an
// FMA can make the two differ (the build also passes --fmad=false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// rows a thread loads at once: a forward stage reads one tensor a row, a
// backward stage two (the grid's plan reads them through lh_bn_rows)
constexpr int kRowsFw = 8;
constexpr int kRowsBw = 4;
constexpr int kFinC = 32;      // finalize block: channels ...
constexpr int kFinLanes = 16;  // ... by lanes over the splits

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of T as loaded: a 16-byte vector, or one element
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load(const T* p) {
  return *reinterpret_cast<const Raw<T, V>*>(p);
}
template <typename T, int V>
__device__ __forceinline__ float elem(const Raw<T, V>& r, int i) {
  return to_f(reinterpret_cast<const T*>(&r)[i]);
}
template <typename T, int V>
__device__ __forceinline__ void put(Raw<T, V>& r, int i, float v) {
  reinterpret_cast<T*>(&r)[i] = from_f<T>(v);
}

// rows base, base + tr, ..., base + (U - 1) * tr of the column at p, those
// below r1, all loads issued before any is used
template <typename T, int V, int U>
__device__ __forceinline__ void load_rows(Raw<T, V> (&v)[U], const T* p,
                                          long long base, int tr,
                                          long long r1, int C) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long r = base + (long long)u * tr;
    if (r < r1) v[u] = load<T, V>(p + r * C);
  }
}

// the normalised value before rounding: (x - mean) * (invstd * w) + b
__device__ __forceinline__ float affine(float xc, float a, float b) {
  return __fadd_rn(__fmul_rn(xc, a), b);
}

__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

// the ReLU's gradient gate: the forward's output o, in T, is > 0 (a NaN
// output passes the gradient, as torch's threshold_backward does)
__device__ __forceinline__ float gate(float o, float g) {
  return o <= 0.f ? 0.f : g;
}

// the gate of the ReLU fused into the BN, from its output recomputed from
// x and rounded to T
template <typename T>
__device__ __forceinline__ float gate_bn(float y, float g) {
  return gate(to_f(from_f<T>(y)), g);
}

// a channel's (mean, invstd): the batch's, or from the running statistics
__device__ __forceinline__ void stats(int eval, const float* s0,
                                      const float* s1, int c, float eps,
                                      float& mean, float& invstd) {
  mean = s0[c];
  invstd = eval ? 1.f / sqrtf(__fadd_rn(s1[c], eps)) : s1[c];
}

// Chan's rule: (n, mean, m2) += (nb, mb, m2b)
__device__ __forceinline__ void chan(float& n, float& mean, float& m2,
                                     float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float wb = nb / nn;
  const float d = mb - mean;
  mean += d * wb;
  m2 += m2b + d * d * (n * wb);
  n = nn;
}

// the rows [r0, r1) of split blockIdx.y, and this thread's first channel
struct Tile {
  int c0;
  long long r0, r1;
};

template <int V>
__device__ __forceinline__ Tile tile(long long rows, long long chunk) {
  Tile t;
  t.c0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  t.r0 = (long long)blockIdx.y * chunk;
  t.r1 = min(rows, t.r0 + chunk);
  return t;
}

// The partials' shared memory holds value i of the thread with linear index
// lin at [i * threads + lin]: a warp's 32 consecutive threads on 32 banks.
// The tree over the block's rows of threads (ty) halves them each step.
__device__ __forceinline__ int first_half(int tr) {
  int half = 1;
  while (half < tr) half <<= 1;
  return half >> 1;
}

// the sum over the finalize block's lanes (ty) of v, for every lane
__device__ __forceinline__ float lanes_sum(float v, float (*sm)[kFinC]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  sm[ty][tx] = v;
  for (int half = kFinLanes / 2; half > 0; half >>= 1) {
    __syncthreads();
    if (ty < half) sm[ty][tx] = v = v + sm[ty + half][tx];
  }
  __syncthreads();
  const float total = sm[0][tx];
  __syncthreads();  // sm is written again by the next call
  return total;
}

// ---------------------------------------------------------------- forward

// partials[0][split][c], partials[1][split][c]: mean and M2 of the split's
// rows of channel c.
template <typename T, int V>
__global__ void __launch_bounds__(256)
lh_bn_fw_partials(const T* __restrict__ x, long long rows, int C,
                  long long chunk, float* __restrict__ part) {
  extern __shared__ float smem[];
  const int tc = blockDim.x, tr = blockDim.y, ty = threadIdx.y;
  const int lin = ty * tc + threadIdx.x, nth = tc * tr;
  const Tile t = tile<V>(rows, chunk);
  float n = 0.f, k[V], s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) k[i] = s[i] = q[i] = 0.f;
  if (t.c0 < C) {
    const T* p = x + t.c0;
    for (long long base = t.r0 + ty; base < t.r1; base += kRowsFw * tr) {
      Raw<T, V> v[kRowsFw];
      load_rows<T, V, kRowsFw>(v, p, base, tr, t.r1, C);
      if (n == 0.f) {  // the shift: the thread's first value of a channel
#pragma unroll
        for (int i = 0; i < V; ++i) k[i] = elem<T, V>(v[0], i);
      }
#pragma unroll
      for (int u = 0; u < kRowsFw; ++u) {
        if (base + (long long)u * tr < t.r1) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float d = elem<T, V>(v[u], i) - k[i];
            s[i] += d;
            q[i] = fmaf(d, d, q[i]);
          }
          n += 1.f;
        }
      }
    }
  }
  // this thread's (mean, M2), then Chan's rule over the block's rows
  float mean[V], m2[V];
  const float inv = n > 0.f ? 1.f / n : 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mean[i] = k[i] + s[i] * inv;
    m2[i] = fmaxf(q[i] - s[i] * (s[i] * inv), 0.f);
  }
  float* sm_mean = smem;
  float* sm_m2 = smem + V * nth;
  float* sm_n = smem + 2 * V * nth;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sm_mean[i * nth + lin] = mean[i];
    sm_m2[i * nth + lin] = m2[i];
  }
  if (threadIdx.x == 0) sm_n[ty] = n;
  for (int half = first_half(tr); half > 0; half >>= 1) {
    __syncthreads();
    if (ty < half && ty + half < tr) {
      const int o = lin + half * tc;
      const float nb = sm_n[ty + half];
      float nn = n;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        nn = n;
        chan(nn, mean[i], m2[i], nb, sm_mean[i * nth + o],
             sm_m2[i * nth + o]);
        sm_mean[i * nth + lin] = mean[i];
        sm_m2[i * nth + lin] = m2[i];
      }
      n = nn;
      if (threadIdx.x == 0) sm_n[ty] = n;
    }
  }
  if (ty == 0 && t.c0 < C) {
    const int splits = gridDim.y;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      part[(long long)blockIdx.y * C + t.c0 + i] = mean[i];
      part[(long long)(splits + blockIdx.y) * C + t.c0 + i] = m2[i];
    }
  }
}

// Merges the splits, Chan's rule in two passes (the mean from the splits'
// sums, then M2 = sum of M2_s + n_s (mean_s - mean)^2: no division a
// split): mean and invstd of each channel; the running statistics lerped
// toward the batch's (biased) ones by `momentum`, as torch's lerp_
// computes it; num_batches_tracked + 1.
__global__ void __launch_bounds__(kFinC * kFinLanes)
lh_bn_fw_finalize(const float* __restrict__ part, int splits, long long rows,
                  long long chunk, int C, float eps, float momentum,
                  float* __restrict__ mean_out, float* __restrict__ invstd_out,
                  float* __restrict__ running_mean,
                  float* __restrict__ running_var,
                  long long* __restrict__ batches) {
  __shared__ float sm[kFinLanes][kFinC];
  const int c = blockIdx.x * kFinC + threadIdx.x;
  const bool on = c < C;
  float acc = 0.f;
  if (on) {
#pragma unroll 4
    for (int s = threadIdx.y; s < splits; s += kFinLanes)
      acc += (float)min(chunk, rows - (long long)s * chunk) *
             part[(long long)s * C + c];
  }
  const float mean = lanes_sum(acc, sm) / (float)rows;
  acc = 0.f;
  if (on) {
#pragma unroll 4
    for (int s = threadIdx.y; s < splits; s += kFinLanes) {
      const float d = part[(long long)s * C + c] - mean;
      acc += part[(long long)(splits + s) * C + c] +
             (float)min(chunk, rows - (long long)s * chunk) * (d * d);
    }
  }
  const float m2 = lanes_sum(acc, sm);
  if (threadIdx.y == 0 && on) {
    const float var = fmaxf(m2 / (float)rows, 0.f);
    mean_out[c] = mean;
    invstd_out[c] = 1.f / sqrtf(__fadd_rn(var, eps));
    const float rm = running_mean[c], rv = running_var[c];
    running_mean[c] = __fadd_rn(rm, __fmul_rn(momentum, mean - rm));
    running_var[c] = __fadd_rn(rv, __fmul_rn(momentum, var - rv));
    if (c == 0) *batches += 1;
  }
}

// The rows of tile t from p to o, U at a time: o = act(affine(x)), rounded
// once to T; with a residual q (R), o = relu(T(T(affine(x)) + r)).
template <typename T, int V, int U, bool R>
__device__ __forceinline__ void apply_rows(const T* __restrict__ p,
                                           const T* __restrict__ q,
                                           T* __restrict__ o, const Tile& t,
                                           int C,
                                           const float (&mu)[V],
                                           const float (&a)[V],
                                           const float (&bb)[V], int act) {
  const int tr = blockDim.y;
  for (long long base = t.r0 + threadIdx.y; base < t.r1; base += U * tr) {
    Raw<T, V> v[U], vr[U];
    load_rows<T, V, U>(v, p, base, tr, t.r1, C);
    if constexpr (R) load_rows<T, V, U>(vr, q, base, tr, t.r1, C);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = base + (long long)u * tr;
      if (r < t.r1) {
        Raw<T, V> out;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float z = affine(elem<T, V>(v[u], i) - mu[i], a[i], bb[i]);
          if constexpr (R)
            z = relu(__fadd_rn(to_f(from_f<T>(z)), elem<T, V>(vr[u], i)));
          put<T, V>(out, i, act ? relu(z) : z);
        }
        *reinterpret_cast<Raw<T, V>*>(o + r * C) = out;
      }
    }
  }
}

// y = act((x - mean) * (invstd * w) + b), rounded once to T; with a
// residual r, y = relu(T(T((x - mean) * (invstd * w) + b) + r)) (act is then
// 0: the ReLU follows the add). A thread loads kRowsFw rows of x at once, or
// half as many rows of both x and r: the same 16-byte vectors in flight, so
// the residual path takes no registers, and no occupancy, from the other.
template <typename T, int V>
__device__ __forceinline__ void bn_apply(const T* __restrict__ x,
                                         const T* __restrict__ res,
                                         T* __restrict__ y, long long rows,
                                         int C, long long chunk, int eval,
                                         const float* __restrict__ s0,
                                         const float* __restrict__ s1,
                                         const float* __restrict__ w,
                                         const float* __restrict__ b,
                                         float eps, int act) {
  const Tile t = tile<V>(rows, chunk);
  if (t.c0 >= C) return;
  float mu[V], a[V], bb[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float inv;
    stats(eval, s0, s1, t.c0 + i, eps, mu[i], inv);
    a[i] = __fmul_rn(inv, w[t.c0 + i]);
    bb[i] = b[t.c0 + i];
  }
  if (res)
    apply_rows<T, V, kRowsFw / 2, true>(x + t.c0, res + t.c0, y + t.c0, t, C,
                                        mu, a, bb, act);
  else
    apply_rows<T, V, kRowsFw, false>(x + t.c0, nullptr, y + t.c0, t, C, mu,
                                     a, bb, act);
}

template <typename T, int V>
__global__ void __launch_bounds__(256)
lh_bn_fw_apply(const T* __restrict__ x, const T* __restrict__ res,
               T* __restrict__ y, long long rows, int C, long long chunk,
               const float* __restrict__ mean,
               const float* __restrict__ invstd, const float* __restrict__ w,
               const float* __restrict__ b, int act) {
  bn_apply<T, V>(x, res, y, rows, C, chunk, 0, mean, invstd, w, b, 0.f, act);
}

template <typename T, int V>
__global__ void __launch_bounds__(256)
lh_bn_fw_eval(const T* __restrict__ x, const T* __restrict__ res,
              T* __restrict__ y, long long rows, int C, long long chunk,
              const float* __restrict__ running_mean,
              const float* __restrict__ running_var,
              const float* __restrict__ w, const float* __restrict__ b,
              float eps, int act) {
  bn_apply<T, V>(x, res, y, rows, C, chunk, 1, running_mean, running_var, w,
                 b, eps, act);
}

// --------------------------------------------------------------- backward

// partials[0][split][c] = sum of dy' and partials[1][split][c] = sum of
// dy' * (x - mean) over the split's rows, dy' the gradient through the ReLU:
// gated by the saved output out where there is one (a residual block's end),
// else by the fused ReLU's output recomputed from x where act
template <typename T, int V>
__global__ void __launch_bounds__(256)
lh_bn_bw_partials(const T* __restrict__ dy, const T* __restrict__ x,
                  const T* __restrict__ out, long long rows, int C,
                  long long chunk, int eval,
                  const float* __restrict__ s0, const float* __restrict__ s1,
                  const float* __restrict__ w, const float* __restrict__ b,
                  float eps, int act, float* __restrict__ part) {
  extern __shared__ float smem[];
  const int tc = blockDim.x, tr = blockDim.y, ty = threadIdx.y;
  const int lin = ty * tc + threadIdx.x, nth = tc * tr;
  const Tile t = tile<V>(rows, chunk);
  float g1[V], g2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) g1[i] = g2[i] = 0.f;
  if (t.c0 < C) {
    float mu[V], a[V], bb[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float inv;
      stats(eval, s0, s1, t.c0 + i, eps, mu[i], inv);
      a[i] = __fmul_rn(inv, w[t.c0 + i]);
      bb[i] = b[t.c0 + i];
    }
    for (long long base = t.r0 + ty; base < t.r1; base += kRowsBw * tr) {
      Raw<T, V> vx[kRowsBw], vg[kRowsBw], vo[kRowsBw];
      load_rows<T, V, kRowsBw>(vx, x + t.c0, base, tr, t.r1, C);
      load_rows<T, V, kRowsBw>(vg, dy + t.c0, base, tr, t.r1, C);
      if (out) load_rows<T, V, kRowsBw>(vo, out + t.c0, base, tr, t.r1, C);
#pragma unroll
      for (int u = 0; u < kRowsBw; ++u) {
        if (base + (long long)u * tr < t.r1) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float xc = elem<T, V>(vx[u], i) - mu[i];
            float g = elem<T, V>(vg[u], i);
            if (out)
              g = gate(elem<T, V>(vo[u], i), g);
            else if (act)
              g = gate_bn<T>(affine(xc, a[i], bb[i]), g);
            g1[i] += g;
            g2[i] = fmaf(g, xc, g2[i]);
          }
        }
      }
    }
  }
  float* sm1 = smem;
  float* sm2 = smem + V * nth;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sm1[i * nth + lin] = g1[i];
    sm2[i * nth + lin] = g2[i];
  }
  for (int half = first_half(tr); half > 0; half >>= 1) {
    __syncthreads();
    if (ty < half && ty + half < tr) {
      const int o = lin + half * tc;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sm1[i * nth + lin] = g1[i] += sm1[i * nth + o];
        sm2[i * nth + lin] = g2[i] += sm2[i * nth + o];
      }
    }
  }
  if (ty == 0 && t.c0 < C) {
    const int splits = gridDim.y;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      part[(long long)blockIdx.y * C + t.c0 + i] = g1[i];
      part[(long long)(splits + blockIdx.y) * C + t.c0 + i] = g2[i];
    }
  }
}

// Sums the splits: grad_bias = sum dy', grad_weight = sum dy' * xhat, and
// the coefficients of dx = k * (dy' - mdy - (x - mean) * q):
// k = w * invstd, mdy = sum dy' / n, q = (sum dy' * xhat) * invstd / n
// (in eval the statistics are constants: mdy = q = 0).
__global__ void __launch_bounds__(kFinC * kFinLanes)
lh_bn_bw_finalize(const float* __restrict__ part, int splits, long long rows,
                  int C, int eval, const float* __restrict__ s0,
                  const float* __restrict__ s1, const float* __restrict__ w,
                  float eps, float* __restrict__ dw, float* __restrict__ db,
                  float* __restrict__ coef) {
  __shared__ float sm[kFinLanes][kFinC];
  const int c = blockIdx.x * kFinC + threadIdx.x;
  const bool on = c < C;
  float a1 = 0.f, a2 = 0.f;
  if (on) {
#pragma unroll 4
    for (int s = threadIdx.y; s < splits; s += kFinLanes) {
      a1 += part[(long long)s * C + c];
      a2 += part[(long long)(splits + s) * C + c];
    }
  }
  const float g1 = lanes_sum(a1, sm);
  const float g2 = lanes_sum(a2, sm);
  if (threadIdx.y == 0 && on) {
    float mean, invstd;
    stats(eval, s0, s1, c, eps, mean, invstd);
    const float gw = g2 * invstd;
    db[c] = g1;
    dw[c] = gw;
    coef[c] = w[c] * invstd;
    coef[C + c] = eval ? 0.f : g1 / (float)rows;
    coef[2 * C + c] = eval ? 0.f : gw * invstd / (float)rows;
  }
}

// dx from dy' as above; where there is a saved output out, also dres = dy'
template <typename T, int V>
__global__ void __launch_bounds__(256)
lh_bn_bw_apply(const T* __restrict__ dy, const T* __restrict__ x,
               const T* __restrict__ out, T* __restrict__ dx,
               T* __restrict__ dres, long long rows, int C, long long chunk,
               int eval, const float* __restrict__ s0,
               const float* __restrict__ s1, const float* __restrict__ w,
               const float* __restrict__ b, float eps, int act,
               const float* __restrict__ coef) {
  const Tile t = tile<V>(rows, chunk);
  if (t.c0 >= C) return;
  const int tr = blockDim.y;
  float mu[V], a[V], bb[V], kk[V], mdy[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t.c0 + i;
    float inv;
    stats(eval, s0, s1, c, eps, mu[i], inv);
    a[i] = __fmul_rn(inv, w[c]);
    bb[i] = b[c];
    kk[i] = coef[c];
    mdy[i] = coef[C + c];
    q[i] = coef[2 * C + c];
  }
  for (long long base = t.r0 + threadIdx.y; base < t.r1;
       base += kRowsBw * tr) {
    Raw<T, V> vx[kRowsBw], vg[kRowsBw], vo[kRowsBw];
    load_rows<T, V, kRowsBw>(vx, x + t.c0, base, tr, t.r1, C);
    load_rows<T, V, kRowsBw>(vg, dy + t.c0, base, tr, t.r1, C);
    if (out) load_rows<T, V, kRowsBw>(vo, out + t.c0, base, tr, t.r1, C);
#pragma unroll
    for (int u = 0; u < kRowsBw; ++u) {
      const long long r = base + (long long)u * tr;
      if (r < t.r1) {
        Raw<T, V> vdx, vdr;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xc = elem<T, V>(vx[u], i) - mu[i];
          float g = elem<T, V>(vg[u], i);
          if (out)
            g = gate(elem<T, V>(vo[u], i), g);
          else if (act)
            g = gate_bn<T>(affine(xc, a[i], bb[i]), g);
          put<T, V>(vdx, i, kk[i] * ((g - mdy[i]) - xc * q[i]));
          put<T, V>(vdr, i, g);
        }
        *reinterpret_cast<Raw<T, V>*>(dx + r * C + t.c0) = vdx;
        if (out) *reinterpret_cast<Raw<T, V>*>(dres + r * C + t.c0) = vdr;
      }
    }
  }
}

// ------------------------------------------------------------------- host

template <typename T_, int V_>
struct Kind {
  using T = T_;
  static constexpr int V = V_;
};

// dtype 0: f32, 1: bf16; vec 1: 16-byte vectors, 0: one element a thread
template <typename F>
int dispatch(int dtype, int vec, F f) {
  if (dtype == 1)
    return vec ? f(Kind<__nv_bfloat16, 8>()) : f(Kind<__nv_bfloat16, 1>());
  if (dtype == 0) return vec ? f(Kind<float, 4>()) : f(Kind<float, 1>());
  return (int)cudaErrorInvalidValue;
}

// the partials' dynamic shared memory: two floats a thread's channel and
// the rows' counts
size_t partial_smem(int tc, int tr, int v) {
  return (size_t)tr * tc * v * 2 * sizeof(float) + (size_t)tr * sizeof(float);
}

dim3 grid(int C, int v, int tc, int splits) {
  return dim3((C / v + tc - 1) / tc, splits);
}

dim3 fin_grid(int C) { return dim3((C + kFinC - 1) / kFinC); }

}  // namespace

// Blocks of (tc, tr) threads that one SM holds at once for stage `stage`
// (0 fw_partials, 1 fw_apply, 2 fw_eval, 3 bw_partials, 4 bw_apply).
extern "C" int lh_bn_occupancy(int stage, int dtype, int vec, int tc, int tr,
                               int* blocks) {
  return dispatch(dtype, vec, [&](auto kind) {
    using T = typename decltype(kind)::T;
    constexpr int V = decltype(kind)::V;
    const void* fns[5] = {(const void*)lh_bn_fw_partials<T, V>,
                          (const void*)lh_bn_fw_apply<T, V>,
                          (const void*)lh_bn_fw_eval<T, V>,
                          (const void*)lh_bn_bw_partials<T, V>,
                          (const void*)lh_bn_bw_apply<T, V>};
    if (stage < 0 || stage > 4) return (int)cudaErrorInvalidValue;
    const size_t smem =
        (stage == 0 || stage == 3) ? partial_smem(tc, tr, V) : 0;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fns[stage], tc * tr, smem);
  });
}

// Rows a thread of stage `stage` loads at once (the stages' codes as in
// lh_bn_occupancy), or -1 for an unknown stage.
extern "C" int lh_bn_rows(int stage) {
  return stage < 0 || stage > 4 ? -1 : stage < 3 ? kRowsFw : kRowsBw;
}

// Training forward. x, y: [rows, C] of dtype; res: the residual, [rows, C]
// of dtype, or null; (tc, tr) the block, (splits, chunk) the partials' grid,
// (asplits, achunk) the apply's; w, b, the running statistics, mean and
// invstd f32 [C]; part f32 [2, splits, C]; batches the int64
// num_batches_tracked. Returns the first launch error.
extern "C" int lh_bn_forward_train(
    const void* x, const void* res, void* y, long long rows, int C,
    int dtype, int vec, int tc, int tr, int splits, long long chunk,
    int asplits, long long achunk, const float* w, const float* b,
    float* running_mean, float* running_var, long long* batches,
    float momentum, float eps, int act, float* part, float* mean,
    float* invstd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch(dtype, vec, [&](auto kind) {
    using T = typename decltype(kind)::T;
    constexpr int V = decltype(kind)::V;
    lh_bn_fw_partials<T, V><<<grid(C, V, tc, splits), dim3(tc, tr),
                              partial_smem(tc, tr, V), st>>>(
        (const T*)x, rows, C, chunk, part);
    cudaError_t err = cudaGetLastError();
    if (err) return (int)err;
    lh_bn_fw_finalize<<<fin_grid(C), dim3(kFinC, kFinLanes), 0, st>>>(
        part, splits, rows, chunk, C, eps, momentum, mean, invstd,
        running_mean, running_var, batches);
    err = cudaGetLastError();
    if (err) return (int)err;
    lh_bn_fw_apply<T, V><<<grid(C, V, tc, asplits), dim3(tc, tr), 0, st>>>(
        (const T*)x, (const T*)res, (T*)y, rows, C, achunk, mean, invstd, w,
        b, act);
    return (int)cudaGetLastError();
  });
}

// Eval forward from the running statistics, one pass; res as above.
extern "C" int lh_bn_forward_eval(const void* x, const void* res, void* y,
                                  long long rows, int C, int dtype, int vec,
                                  int tc, int tr, int splits, long long chunk,
                                  const float* w, const float* b,
                                  const float* running_mean,
                                  const float* running_var, float eps,
                                  int act, void* stream) {
  return dispatch(dtype, vec, [&](auto kind) {
    using T = typename decltype(kind)::T;
    constexpr int V = decltype(kind)::V;
    lh_bn_fw_eval<T, V><<<grid(C, V, tc, splits), dim3(tc, tr), 0,
                          (cudaStream_t)stream>>>(
        (const T*)x, (const T*)res, (T*)y, rows, C, chunk, running_mean,
        running_var, w, b, eps, act);
    return (int)cudaGetLastError();
  });
}

// Backward. out: the saved output of a residual block's end, or null; dres:
// the residual's gradient, [rows, C] of dtype, written where out is given;
// s0, s1: the saved mean and invstd (eval = 0) or the running mean and
// variance (eval = 1); part f32 [2, splits, C]; dw, db f32 [C]; coef f32
// [3, C] scratch.
extern "C" int lh_bn_backward(
    const void* dy, const void* x, const void* out, void* dx, void* dres,
    long long rows, int C, int dtype,
    int vec, int tc, int tr, int splits, long long chunk, int asplits,
    long long achunk, const float* w, const float* b, const float* s0,
    const float* s1, int eval, float eps, int act, float* part, float* dw,
    float* db, float* coef, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch(dtype, vec, [&](auto kind) {
    using T = typename decltype(kind)::T;
    constexpr int V = decltype(kind)::V;
    lh_bn_bw_partials<T, V><<<grid(C, V, tc, splits), dim3(tc, tr),
                              partial_smem(tc, tr, V), st>>>(
        (const T*)dy, (const T*)x, (const T*)out, rows, C, chunk, eval, s0, s1,
        w, b, eps, act, part);
    cudaError_t err = cudaGetLastError();
    if (err) return (int)err;
    lh_bn_bw_finalize<<<fin_grid(C), dim3(kFinC, kFinLanes), 0, st>>>(
        part, splits, rows, C, eval, s0, s1, w, eps, dw, db, coef);
    err = cudaGetLastError();
    if (err) return (int)err;
    lh_bn_bw_apply<T, V><<<grid(C, V, tc, asplits), dim3(tc, tr), 0, st>>>(
        (const T*)dy, (const T*)x, (const T*)out, (T*)dx, (T*)dres, rows, C,
        achunk, eval, s0, s1, w, b, eps, act, coef);
    return (int)cudaGetLastError();
  });
}
