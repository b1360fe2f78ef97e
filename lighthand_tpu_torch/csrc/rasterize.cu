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
// the z-buffer's and below far: of the candidate faces, the least (depth,
// face index). A pixel that keeps the least (depth, index) of the faces it
// walks, in any order and split over several threads, keeps exactly that
// face, with no atomics. Two launches:
//   1. raster_setup, a thread a face: the loop's culls, the face's clipped
//      box and denominator (load_face), written as a box (4 ints, all zero
//      where the face is not drawn) and a record (corners, depths,
//      denominator), and for each 32 consecutive faces (a warp) the union
//      of their drawn boxes, by warp reductions, into scratch of F faces;
//   2. raster_tiles, a block a screen tile of tile_w x tile_h pixels, sub
//      threads a pixel. The block tests the group boxes (a thread each),
//      then the faces of the groups that meet the tile (a warp a group),
//      and appends those whose box meets it to a list in shared memory
//      (box, record, index) at the places a block-wide count gives, so the
//      list keeps index order; a face's record is loaded as its box is
//      counted. Where a pass would overflow the list's capacity, the
//      threads first walk the list and empty it. A walk orders the list
//      by its faces' nearest corner depth; thread s of a pixel walks the
//      ordered entries s, s + sub, ... with the loop's box test and
//      sample(), keeping the least (depth, face), and stops at the first
//      entry whose depth bound is beyond its best (beyond()). The least
//      over the pixel's threads (shuffles) wins, and its thread computes
//      that sample again to write the winner's colour, or the background
//      where no face won, clipped to [0, 1] (NaN kept, as torch.clamp
//      keeps it). A tile that no group meets only copies and clips the
//      background.
// Every quantity is computed with numpy's expressions in numpy's order,
// each operation rounded once (built with --fmad=false, IEEE division).
// The tile size, the threads a pixel and the list's capacity come from the
// wrapper (ops/kernels/rasterize.py), whose tests replay the block's walk
// in numpy.
//
// Bound on an H100: bytes. A hand of ~1.5k faces at 800x600 covers some
// 2 x 10^6 box pixels at ~26 f64 operations each (about 1.6 us at 34
// TFLOP/s), while the background read and the image written are 23 MB (6.9
// us at 3.35 TB/s). What the design does about the time that is not bytes
// (found on the card with per-block timers):
//   - a tile's time is its scan, a chain of L2 round trips and barriers,
//     then a walk whose every entry is a chain of up to three dependent f64
//     divisions. The group boxes cut the scan to the faces near the tile
//     (a hand's consecutive faces are neighbours); small tiles with
//     several threads a pixel spread the crowded tiles (the mesh's poles,
//     where up to 160 boxes meet one 16 x 16 tile) over more threads;
//   - walking the faces nearest first stops a covered pixel soon after its
//     winner. Skipping divisions by a sign test on the numerators, loading
//     records during the scan, the background at the block's start, and
//     two samples a thread in turn were slower or no faster on the card;
//   - the per-pixel scratch of the first version (a z-buffer of bits and a
//     winner) and its init and atomic passes are gone: the image is the
//     only per-pixel memory.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kSetupThreads = 128;
constexpr int kMaxTileThreads = 512;  // 128 registers a thread

struct __align__(16) Tri {
  double px[3], py[3], z[3], denom;
};

struct Face : Tri {
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

// The depth is computed only inside the triangle, the only place the loop
// uses it.
__device__ Sample sample(const Tri& t, int x, int y, double far_z) {
  const double xs = (double)x + 0.5, ys = (double)y + 0.5;
  Sample s;
  s.w1 = ((xs - t.px[0]) * (t.py[2] - t.py[0]) -
          (t.px[2] - t.px[0]) * (ys - t.py[0])) /
         t.denom;
  s.w2 = ((t.px[1] - t.px[0]) * (ys - t.py[0]) -
          (xs - t.px[0]) * (t.py[1] - t.py[0])) /
         t.denom;
  s.w0 = 1.0 - s.w1 - s.w2;
  s.candidate = s.w0 >= 0.0 && s.w1 >= 0.0 && s.w2 >= 0.0;
  if (s.candidate) {
    const double inv_z = s.w0 / t.z[0] + s.w1 / t.z[1] + s.w2 / t.z[2];
    s.pix_z = 1.0 / fmax(inv_z, 1e-12);
    s.candidate = s.pix_z < far_z;
  }
  return s;
}

// A face's sort key: its nearest corner depth (fmin passes over a NaN
// depth; +inf where every depth is NaN).
__device__ __forceinline__ double near_key(const Tri& t) {
  const double zmin = fmin(fmin(t.z[0], t.z[1]), t.z[2]);
  return zmin == zmin ? zmin : __longlong_as_double(0x7FF0000000000000LL);
}

// Whether no pixel of a face of key zmin can beat best: inside the
// triangle (w0, w1, w2 >= 0, summing to 1 within 3.01 2^-53) the computed
// depth, 1 / fmax(inv_z, 1e-12), is at least min(zmin (1 - 7.2 2^-53),
// 1e12) where every depth is at least 2^-900 (no subnormal on the way);
// 1e12 where a depth is NaN (inv_z is NaN, fmax takes 1e-12). So a face
// whose bound, min(zmin (1 - 2^-48), 1e12), is above best cannot have a
// depth at or below it. The bound grows with zmin.
__device__ __forceinline__ bool beyond(double zmin, double best) {
  return zmin >= 0x1p-900 && best < fmin(zmin * (1.0 - 0x1p-48), 1e12);
}

__device__ double clip01(double v) {
  return v != v ? v : fmin(fmax(v, 0.0), 1.0);
}

// One thread a face, a warp 32 consecutive faces: the face's box (all
// zero where it is not drawn) and record, and the group's box, the union
// of its drawn faces' boxes (all zero where none is drawn).
__global__ void __launch_bounds__(kSetupThreads)
raster_setup(const double* __restrict__ vpx, const double* __restrict__ vz,
             const int* __restrict__ faces, int n_faces, int h, int w,
             double near_z, double far_z, int4* __restrict__ boxes,
             Tri* __restrict__ tris, int4* __restrict__ groups) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  bool drawn = false;
  int4 b = make_int4(0, 0, 0, 0);
  if (f < n_faces) {
    const Face t = load_face(vpx, vz, faces, f, h, w, near_z, far_z);
    b = make_int4(t.x0, t.x1, t.y0, t.y1);
    drawn = t.keep;
    boxes[f] = b;
    tris[f] = t;
  }
  const unsigned all = 0xffffffffu;
  const int x0 = __reduce_min_sync(all, drawn ? b.x : INT_MAX);
  const int x1 = __reduce_max_sync(all, drawn ? b.y : INT_MIN);
  const int y0 = __reduce_min_sync(all, drawn ? b.z : INT_MAX);
  const int y1 = __reduce_max_sync(all, drawn ? b.w : INT_MIN);
  const bool any = __any_sync(all, drawn);  // every lane takes part
  if ((threadIdx.x & 31) == 0 && f < n_faces)
    groups[f / 32] = any ? make_int4(x0, x1, y0, y1) : make_int4(0, 0, 0, 0);
}

// Shared memory: the list's records, boxes, face indices, sort keys and
// order (cap each), the hit groups of a pass (one a thread), then two sets
// of per-warp counts (the set alternates, so a count that adds nothing
// needs one barrier). The scan takes the groups in passes of a thread
// each, the faces of the groups that meet the tile in passes of a warp a
// group; the records of the listed faces are copied in at once before a
// walk. Threads: sub a pixel (1, 2 or 4, neighbours in a warp); the least
// (depth, face) of a pixel's threads, by shuffles, is the loop's winner,
// whose sample its thread computes again to shade.
__global__ void __launch_bounds__(kMaxTileThreads)
raster_tiles(const int4* __restrict__ boxes, const Tri* __restrict__ tris,
             const int4* __restrict__ groups, const int* __restrict__ faces,
             const double* __restrict__ colors,
             const double* __restrict__ background, int n_faces, int h, int w,
             double far_z, int tile_w, int tile_h, int sub, int cap,
             double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  Tri* list = reinterpret_cast<Tri*>(smem);
  int4* lbox = reinterpret_cast<int4*>(list + cap);
  int* lface = reinterpret_cast<int*>(lbox + cap);
  double* key = reinterpret_cast<double*>(lface + cap + (cap & 1));
  int* order = reinterpret_cast<int*>(key + cap);
  int* glist = order + cap;
  int* counts = glist + nt;  // [2][warps]

  const int tx0 = blockIdx.x * tile_w, ty0 = blockIdx.y * tile_h;
  const int tx1 = min(tx0 + tile_w, w), ty1 = min(ty0 + tile_h, h);
  const int px = tid / sub, part = tid - px * sub;
  const int x = tx0 + px % tile_w, y = ty0 + px / tile_w;
  const bool mine = x < w && y < h;
  auto meets = [&](int4 b) {
    return b.x < b.y && b.x < tx1 && b.y > tx0 && b.z < ty1 && b.w > ty0;
  };

  double best_z = __longlong_as_double(0x7FF0000000000000LL);  // +inf
  int best_f = -1;
  int count = 0;  // faces in the list
  // The list's records in, then its order by (key, face): each entry's
  // rank is the count of entries before it. A pixel's threads walk the
  // entries nearest first, keep the least (depth, face), and stop at the
  // first entry beyond their best: every later one is too.
  auto walk = [&]() {
    for (int i = tid; i < count; i += nt) {
      list[i] = tris[lface[i]];
      key[i] = near_key(list[i]);
    }
    __syncthreads();
    for (int i = tid; i < count; i += nt) {
      int rank = 0;
      for (int j = 0; j < count; ++j)
        rank += key[j] < key[i] || (key[j] == key[i] && lface[j] < lface[i]);
      order[rank] = i;
    }
    __syncthreads();
    if (!mine) return;
    for (int k = part; k < count; k += sub) {
      const int i = order[k];
      if (beyond(key[i], best_z)) break;
      const int4 b = lbox[i];
      if (x < b.x || x >= b.y || y < b.z || y >= b.w) continue;
      const Sample s = sample(list[i], x, y, far_z);
      const int f = lface[i];
      if (s.candidate &&
          (s.pix_z < best_z || (s.pix_z == best_z && f < best_f))) {
        best_z = s.pix_z;
        best_f = f;
      }
    }
  };
  // The block-wide count of `flag` in thread order: (threads before this
  // one with it, all threads with it).
  int set = 0;
  auto tally = [&](bool flag, int& before, int& total) {
    const unsigned m = __ballot_sync(0xffffffffu, flag);
    int* c = counts + set * warps;
    set ^= 1;
    if (lane == 0) c[warp] = __popc(m);
    __syncthreads();
    before = __popc(m & ((1u << lane) - 1u));
    total = 0;
    for (int i = 0; i < warps; ++i) {
      before += i < warp ? c[i] : 0;
      total += c[i];
    }
  };

  const int n_groups = (n_faces + 31) / 32;
  for (int g0 = 0; g0 < n_groups; g0 += nt) {
    const bool ghit = g0 + tid < n_groups && meets(groups[g0 + tid]);
    int before, hits;
    tally(ghit, before, hits);
    if (hits == 0) continue;
    if (ghit) glist[before] = g0 + tid;
    __syncthreads();  // the pass's hit groups in order
    for (int k = 0; k < hits; k += warps) {
      const int f = k + warp < hits ? 32 * glist[k + warp] + lane : n_faces;
      const int4 b = f < n_faces ? boxes[f] : make_int4(0, 0, 0, 0);
      const bool hit = meets(b);
      int total;
      tally(hit, before, total);
      if (total == 0) continue;
      if (count + total > cap) {  // the same for every thread
        walk();
        __syncthreads();  // the list read; it may be refilled
        count = 0;
      }
      if (hit) {
        lbox[count + before] = b;
        lface[count + before] = f;
      }
      count += total;
    }
    __syncthreads();  // the list's entries in; glist free
  }
  walk();

  // the pixel's least (depth, face) over its threads; the thread that
  // holds it shades (no face: thread 0 copies the background)
  double z_min = best_z;
  int f_min = best_f;
  for (int d = 1; d < sub; d <<= 1) {
    const double oz = __shfl_xor_sync(0xffffffffu, z_min, d);
    const int of = __shfl_xor_sync(0xffffffffu, f_min, d);
    if (oz < z_min || (oz == z_min && of < f_min)) {
      z_min = oz;
      f_min = of;
    }
  }
  if (!mine || best_f != f_min || (f_min < 0 && part != 0)) return;
  const long long pix = (long long)y * w + x;
  if (best_f < 0) {
    for (int c = 0; c < 3; ++c)
      out[3 * pix + c] = clip01(background[3 * pix + c]);
    return;
  }
  const Tri t = tris[best_f];
  const Sample s = sample(t, x, y, far_z);
  const int v0 = faces[3 * best_f], v1 = faces[3 * best_f + 1],
            v2 = faces[3 * best_f + 2];
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
// scratch: 96 bytes a face and 16 a group of 32 faces, 16-byte aligned
// (the boxes, the records, the group boxes); a block a tile of tile_w x
// tile_h pixels, sub (1, 2 or 4) threads a pixel, a multiple of 32 threads
// and at most 512; cap: faces the list holds, at least the block's
// threads. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue (1) for sizes the kernels do not take.
extern "C" int lh_rasterize(const double* verts_px, const double* verts_z,
                            const int* faces, const double* colors,
                            const double* background, int n_faces, int h,
                            int w, double near_z, double far_z, double* out,
                            void* scratch, int tile_w, int tile_h, int sub,
                            int cap, void* stream) {
  const int nt = tile_w * tile_h * sub;
  if (tile_w <= 0 || tile_h <= 0 || (sub != 1 && sub != 2 && sub != 4) ||
      nt > kMaxTileThreads || nt % 32 != 0 || cap < nt || n_faces < 0)
    return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return 0;
  const long long gy = ((long long)h + tile_h - 1) / tile_h;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int4* boxes = static_cast<int4*>(scratch);
  Tri* tris = reinterpret_cast<Tri*>(boxes + n_faces);
  int4* groups = reinterpret_cast<int4*>(tris + n_faces);
  if (n_faces > 0)
    raster_setup<<<(n_faces + kSetupThreads - 1) / kSetupThreads,
                   kSetupThreads, 0, s>>>(verts_px, verts_z, faces, n_faces,
                                          h, w, near_z, far_z, boxes, tris,
                                          groups);
  const int smem = cap * (int)(sizeof(Tri) + sizeof(int4) + 2 * sizeof(int) +
                         sizeof(double)) +
                   (nt + 2 * (nt / 32) + 1) * (int)sizeof(int);
  static int sized = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        raster_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  const dim3 grid((unsigned)((w + tile_w - 1) / tile_w), (unsigned)gy);
  raster_tiles<<<grid, nt, smem, s>>>(boxes, tris, groups, faces, colors,
                                      background, n_faces, h, w, far_z,
                                      tile_w, tile_h, sub, cap, out);
  return (int)cudaGetLastError();
}
