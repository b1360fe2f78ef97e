// The mesh renderer's z-buffered, perspective-correct rasterizer: faces
// [F, 3] over projected vertices [V, 2] with depths [V] and colours [V, 3]
// onto a background [H, W, 3], all f64 -> the image [H, W, 3], clipped to
// [0, 1].
//
// Replaces lighthand_tpu/utils/mesh_render.py:rasterize_mesh (the JAX
// package's host loop, one face at a time in numpy; no Pallas kernel).
//
// What it must compute: the loop's image, bit for bit. The loop keeps, at
// each pixel, the first face in index order whose depth is strictly below
// the z-buffer's and below far: the smallest depth, and the smallest face
// index among equal depths. Blocks run in no order here, so that rule is
// built from atomics that do not depend on order, in three passes:
//   1. one block per face walks the face's clipped box: each covered pixel
//      atomicMin's the bit pattern of its depth into zbits (all depths are
//      positive, where an f64's bits order as its values do);
//   2. the same walk: where the depth's bits equal the minimum, atomicMin
//      of the face index into winner;
//   3. one thread per pixel: the winning face's colour at the pixel, or
//      the background, clipped to [0, 1] (NaN kept, as torch.clamp keeps
//      it).
// Every quantity is computed with numpy's expressions in numpy's order,
// each operation rounded once (built with --fmad=false, IEEE division), so
// pass 3 recomputes exactly the values passes 1 and 2 compared.
//
// Bound on an H100: bytes. A hand of ~1.5k faces at 800x600 covers some
// 10^5 box pixels at ~26 f64 operations each (a few us at 34 TFLOP/s),
// while the background read and the image written are 23 MB (6.9 us at
// 3.35 TB/s). This first version is simple: one block of 128 threads per
// face, however large its box, and three passes over the faces' boxes.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;

struct Face {
  double px[3], py[3], z[3], denom;
  int x0, x1, y0, y1;
  bool keep;
};

__device__ Face load_face(const double* __restrict__ vpx,
                          const double* __restrict__ vz,
                          const int* __restrict__ faces, int f, int h, int w,
                          double near_z, double far_z) {
  Face t;
  bool any_near = false, all_far = true;
  for (int k = 0; k < 3; ++k) {
    const int v = faces[3 * f + k];
    t.px[k] = vpx[2 * v];
    t.py[k] = vpx[2 * v + 1];
    t.z[k] = vz[v];
    any_near |= t.z[k] <= near_z;
    all_far &= t.z[k] >= far_z;
  }
  const double fx0 = fmax(floor(fmin(fmin(t.px[0], t.px[1]), t.px[2])), 0.0);
  const double fx1 =
      fmin(ceil(fmax(fmax(t.px[0], t.px[1]), t.px[2])) + 1.0, (double)w);
  const double fy0 = fmax(floor(fmin(fmin(t.py[0], t.py[1]), t.py[2])), 0.0);
  const double fy1 =
      fmin(ceil(fmax(fmax(t.py[0], t.py[1]), t.py[2])) + 1.0, (double)h);
  t.denom = (t.px[1] - t.px[0]) * (t.py[2] - t.py[0]) -
            (t.px[2] - t.px[0]) * (t.py[1] - t.py[0]);
  t.keep = !any_near && !all_far && fx0 < fx1 && fy0 < fy1 &&
           !(fabs(t.denom) < 1e-12);
  t.x0 = t.keep ? (int)fx0 : 0;
  t.x1 = t.keep ? (int)fx1 : 0;
  t.y0 = t.keep ? (int)fy0 : 0;
  t.y1 = t.keep ? (int)fy1 : 0;
  return t;
}

struct Sample {
  double w0, w1, w2, pix_z;
  bool candidate;  // inside the triangle and nearer than far
};

__device__ Sample sample(const Face& t, int x, int y, double far_z) {
  const double xs = (double)x + 0.5, ys = (double)y + 0.5;
  Sample s;
  s.w1 = ((xs - t.px[0]) * (t.py[2] - t.py[0]) -
          (t.px[2] - t.px[0]) * (ys - t.py[0])) /
         t.denom;
  s.w2 = ((t.px[1] - t.px[0]) * (ys - t.py[0]) -
          (xs - t.px[0]) * (t.py[1] - t.py[0])) /
         t.denom;
  s.w0 = 1.0 - s.w1 - s.w2;
  const double inv_z = s.w0 / t.z[0] + s.w1 / t.z[1] + s.w2 / t.z[2];
  s.pix_z = 1.0 / fmax(inv_z, 1e-12);
  s.candidate =
      s.w0 >= 0.0 && s.w1 >= 0.0 && s.w2 >= 0.0 && s.pix_z < far_z;
  return s;
}

__global__ void init_kernel(unsigned long long* __restrict__ zbits,
                            int* __restrict__ winner, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    zbits[i] = 0x7FF0000000000000ULL;  // the bits of +inf
    winner[i] = INT_MAX;
  }
}

// pass 1 (first_pass) and pass 2: one block per face over its box
__global__ void __launch_bounds__(kThreads)
depth_pass(const double* __restrict__ vpx, const double* __restrict__ vz,
           const int* __restrict__ faces, int h, int w, double near_z,
           double far_z, unsigned long long* __restrict__ zbits,
           int* __restrict__ winner, bool first_pass) {
  const int f = blockIdx.x;
  const Face t = load_face(vpx, vz, faces, f, h, w, near_z, far_z);
  if (!t.keep) return;
  const int bw = t.x1 - t.x0;
  const int n = bw * (t.y1 - t.y0);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int x = t.x0 + i % bw, y = t.y0 + i / bw;
    const Sample s = sample(t, x, y, far_z);
    if (!s.candidate) continue;
    const unsigned long long bits =
        (unsigned long long)__double_as_longlong(s.pix_z);
    const int pix = y * w + x;
    if (first_pass) {
      atomicMin(&zbits[pix], bits);
    } else if (bits == zbits[pix]) {
      atomicMin(&winner[pix], f);
    }
  }
}

__device__ double clip01(double v) {
  return v != v ? v : fmin(fmax(v, 0.0), 1.0);
}

// pass 3: one thread per pixel
__global__ void shade_kernel(const double* __restrict__ vpx,
                             const double* __restrict__ vz,
                             const int* __restrict__ faces,
                             const double* __restrict__ colors,
                             const double* __restrict__ background, int h,
                             int w, double near_z, double far_z,
                             const int* __restrict__ winner,
                             double* __restrict__ out) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= h * w) return;
  const int f = winner[pix];
  if (f == INT_MAX) {
    for (int c = 0; c < 3; ++c) {
      out[3 * pix + c] = clip01(background[3 * pix + c]);
    }
    return;
  }
  const Face t = load_face(vpx, vz, faces, f, h, w, near_z, far_z);
  const Sample s = sample(t, pix % w, pix / w, far_z);
  const int v0 = faces[3 * f], v1 = faces[3 * f + 1], v2 = faces[3 * f + 2];
  for (int c = 0; c < 3; ++c) {
    const double a = s.w0 * colors[3 * v0 + c] / t.z[0] +
                     s.w1 * colors[3 * v1 + c] / t.z[1] +
                     s.w2 * colors[3 * v2 + c] / t.z[2];
    out[3 * pix + c] = clip01(a * s.pix_z);
  }
}

}  // namespace

// verts_px [V, 2], verts_z [V], colors [V, 3], background and out
// [H, W, 3]: f64, contiguous; faces [F, 3] int32 with indices in [0, V);
// zbits and winner: [H, W] scratch of 8 and 4 bytes. Returns
// cudaGetLastError() after the launches.
extern "C" int lh_rasterize(const double* verts_px, const double* verts_z,
                            const int* faces, const double* colors,
                            const double* background, int n_faces, int h,
                            int w, double near_z, double far_z, double* out,
                            long long* zbits, int* winner, void* stream) {
  const int n = h * w;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* zb = (unsigned long long*)zbits;
  const int blocks = (n + 255) / 256;
  init_kernel<<<blocks, 256, 0, s>>>(zb, winner, n);
  if (n_faces > 0) {
    depth_pass<<<n_faces, kThreads, 0, s>>>(verts_px, verts_z, faces, h, w,
                                            near_z, far_z, zb, winner, true);
    depth_pass<<<n_faces, kThreads, 0, s>>>(verts_px, verts_z, faces, h, w,
                                            near_z, far_z, zb, winner, false);
  }
  shade_kernel<<<blocks, 256, 0, s>>>(verts_px, verts_z, faces, colors,
                                      background, h, w, near_z, far_z, winner,
                                      out);
  return (int)cudaGetLastError();
}
