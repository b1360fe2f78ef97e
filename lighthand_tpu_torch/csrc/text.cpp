// Host C++: OpenCV 5.0's glyph rasterizer and text blend, for the port's
// put_text (utils/visualize.py). Built by g++ with -ffp-contract=off, so
// the f32 arithmetic runs in the order written, as in OpenCV's build.
//
// OpenCV 5.0 draws FontFace text through its copy of stb_truetype 1.26:
//   - a glyph's box is floor / ceil of its font-unit box times the scale;
//     the bitmap is that box grown by a margin of
//     max((w + 9) / 10, (h + 9) / 10) + 10 pixels on every side, and the
//     outline is placed with the margin as its (f32) shift, so every edge
//     coordinate is `p * scale + margin` rounded in f32;
//   - curves are flattened by recursive halving to 0.35 px (in font units:
//     0.35 / scale), edges are sorted by stb's quicksort + insertion sort,
//     and each scanline accumulates signed trapezoid areas (stb's
//     "version 2" rasterizer) into a coverage of min(255, (int)(|a|*255+.5));
//   - the coverage a is blended per colour channel as (b * (255 - a) +
//     c * a + 127) / 255; a fourth channel is set to a.
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Pt { float x, y; };
struct Edge { float x0, y0, x1, y1; int invert; };
struct Active {
  Active* next;
  float fx, fdx, fdy, direction, sy, ey;
};

enum { kMove = 1, kLine = 2, kCurve = 3 };

void add_point(Pt* p, int n, float x, float y) {
  if (!p) return;
  p[n].x = x;
  p[n].y = y;
}

void tesselate(Pt* p, int* n_points, float x0, float y0, float x1, float y1,
               float x2, float y2, float flat2, int n) {
  float mx = (x0 + 2 * x1 + x2) / 4;
  float my = (y0 + 2 * y1 + y2) / 4;
  float dx = (x0 + x2) / 2 - mx;
  float dy = (y0 + y2) / 2 - my;
  if (n > 16) return;
  if (dx * dx + dy * dy > flat2) {
    tesselate(p, n_points, x0, y0, (x0 + x1) / 2.0f, (y0 + y1) / 2.0f, mx, my,
              flat2, n + 1);
    tesselate(p, n_points, mx, my, (x1 + x2) / 2.0f, (y1 + y2) / 2.0f, x2, y2,
              flat2, n + 1);
  } else {
    add_point(p, *n_points, x2, y2);
    *n_points = *n_points + 1;
  }
}

inline bool less_y0(const Edge* a, const Edge* b) { return a->y0 < b->y0; }

void sort_insertion(Edge* p, int n) {
  for (int i = 1; i < n; ++i) {
    Edge t = p[i];
    int j = i;
    while (j > 0) {
      if (!less_y0(&t, &p[j - 1])) break;
      p[j] = p[j - 1];
      --j;
    }
    if (i != j) p[j] = t;
  }
}

void sort_quick(Edge* p, int n) {
  while (n > 12) {
    Edge t;
    int m = n >> 1;
    int c01 = less_y0(&p[0], &p[m]);
    int c12 = less_y0(&p[m], &p[n - 1]);
    if (c01 != c12) {
      int c = less_y0(&p[0], &p[n - 1]);
      int z = (c == c12) ? 0 : n - 1;
      t = p[z]; p[z] = p[m]; p[m] = t;
    }
    t = p[0]; p[0] = p[m]; p[m] = t;
    int i = 1, j = n - 1;
    for (;;) {
      for (;; ++i) if (!less_y0(&p[i], &p[0])) break;
      for (;; --j) if (!less_y0(&p[0], &p[j])) break;
      if (i >= j) break;
      t = p[i]; p[i] = p[j]; p[j] = t;
      ++i; --j;
    }
    if (j < (n - i)) {
      sort_quick(p, j);
      p = p + i;
      n = n - i;
    } else {
      sort_quick(p + i, n - i);
      n = j;
    }
  }
}

// The edge does not cross the vertical lines at x or x+1.
void clipped_edge(float* scanline, int x, const Active* e, float x0, float y0,
                  float x1, float y1) {
  if (y0 == y1) return;
  if (y0 > e->ey) return;
  if (y1 < e->sy) return;
  if (y0 < e->sy) {
    x0 += (x1 - x0) * (e->sy - y0) / (y1 - y0);
    y0 = e->sy;
  }
  if (y1 > e->ey) {
    x1 += (x1 - x0) * (e->ey - y1) / (y1 - y0);
    y1 = e->ey;
  }
  if (x0 <= x && x1 <= x)
    scanline[x] += e->direction * (y1 - y0);
  else if (x0 >= x + 1 && x1 >= x + 1)
    ;
  else
    scanline[x] += e->direction * (y1 - y0) * (1 - ((x0 - x) + (x1 - x)) / 2);
}

inline float trapezoid(float height, float top_w, float bottom_w) {
  return (top_w + bottom_w) / 2.0f * height;
}

void fill_active(float* scanline, float* fill, int len, Active* e,
                 float y_top) {
  float y_bottom = y_top + 1;
  for (; e; e = e->next) {
    if (e->fdx == 0) {
      float x0 = e->fx;
      if (x0 < len) {
        if (x0 >= 0) {
          clipped_edge(scanline, (int)x0, e, x0, y_top, x0, y_bottom);
          clipped_edge(fill - 1, (int)x0 + 1, e, x0, y_top, x0, y_bottom);
        } else {
          clipped_edge(fill - 1, 0, e, x0, y_top, x0, y_bottom);
        }
      }
      continue;
    }
    float x0 = e->fx, dx = e->fdx, xb = x0 + dx, dy = e->fdy;
    float x_top, x_bottom, sy0, sy1;
    if (e->sy > y_top) {
      x_top = x0 + dx * (e->sy - y_top);
      sy0 = e->sy;
    } else {
      x_top = x0;
      sy0 = y_top;
    }
    if (e->ey < y_bottom) {
      x_bottom = x0 + dx * (e->ey - y_top);
      sy1 = e->ey;
    } else {
      x_bottom = xb;
      sy1 = y_bottom;
    }
    if (x_top >= 0 && x_bottom >= 0 && x_top < len && x_bottom < len) {
      if ((int)x_top == (int)x_bottom) {
        int x = (int)x_top;
        float height = (sy1 - sy0) * e->direction;
        scanline[x] += trapezoid(height, x + 1.0f - x_top, x + 1.0f - x_bottom);
        fill[x] += height;
      } else {
        if (x_top > x_bottom) {  // flip vertically; the signed area is kept
          float t;
          sy0 = y_bottom - (sy0 - y_top);
          sy1 = y_bottom - (sy1 - y_top);
          t = sy0, sy0 = sy1, sy1 = t;
          t = x_bottom, x_bottom = x_top, x_top = t;
          dx = -dx;
          dy = -dy;
          t = x0, x0 = xb, xb = t;
        }
        int x1 = (int)x_top, x2 = (int)x_bottom;
        float y_crossing = y_top + dy * (x1 + 1 - x0);
        float y_final = y_top + dy * (x2 - x0);
        if (y_crossing > y_bottom) y_crossing = y_bottom;
        float sign = e->direction;
        float area = sign * (y_crossing - sy0);
        scanline[x1] += area * (x1 + 1 - x_top) / 2;
        if (y_final > y_bottom) {
          int denom = x2 - (x1 + 1);
          y_final = y_bottom;
          if (denom != 0) dy = (y_final - y_crossing) / denom;
        }
        float step = sign * dy * 1;
        for (int x = x1 + 1; x < x2; ++x) {
          scanline[x] += area + step / 2;
          area += step;
        }
        scanline[x2] += area + sign * trapezoid(sy1 - y_final, x2 + 1.0f - x2,
                                                x2 + 1.0f - x_bottom);
        fill[x2] += sign * (sy1 - sy0);
      }
    } else {
      // the edge leaves the bitmap: clip it against every pixel column
      for (int x = 0; x < len; ++x) {
        float y0 = y_top, x1 = (float)x, x2 = (float)(x + 1), x3 = xb;
        float y3 = y_bottom;
        float y1 = (x - x0) / dx + y_top;
        float y2 = (x + 1 - x0) / dx + y_top;
        if (x0 < x1 && x3 > x2) {
          clipped_edge(scanline, x, e, x0, y0, x1, y1);
          clipped_edge(scanline, x, e, x1, y1, x2, y2);
          clipped_edge(scanline, x, e, x2, y2, x3, y3);
        } else if (x3 < x1 && x0 > x2) {
          clipped_edge(scanline, x, e, x0, y0, x2, y2);
          clipped_edge(scanline, x, e, x2, y2, x1, y1);
          clipped_edge(scanline, x, e, x1, y1, x3, y3);
        } else if (x0 < x1 && x3 > x1) {
          clipped_edge(scanline, x, e, x0, y0, x1, y1);
          clipped_edge(scanline, x, e, x1, y1, x3, y3);
        } else if (x3 < x1 && x0 > x1) {
          clipped_edge(scanline, x, e, x0, y0, x1, y1);
          clipped_edge(scanline, x, e, x1, y1, x3, y3);
        } else if (x0 < x2 && x3 > x2) {
          clipped_edge(scanline, x, e, x0, y0, x2, y2);
          clipped_edge(scanline, x, e, x2, y2, x3, y3);
        } else if (x3 < x2 && x0 > x2) {
          clipped_edge(scanline, x, e, x0, y0, x2, y2);
          clipped_edge(scanline, x, e, x2, y2, x3, y3);
        } else {
          clipped_edge(scanline, x, e, x0, y0, x3, y3);
        }
      }
    }
  }
}

void rasterize_sorted(uint8_t* out, int w, int h, Edge* e, int n, int off_x,
                      int off_y) {
  std::vector<float> buf(2 * w + 1);
  float* scanline = buf.data();
  float* scanline2 = scanline + w;
  std::vector<Active> pool(n + 1);
  int used = 0;
  Active* active = nullptr;
  int y = off_y;
  e[n].y0 = (float)(off_y + h) + 1;  // sentinel
  for (int j = 0; j < h; ++j, ++y) {
    float scan_y_top = y + 0.0f, scan_y_bottom = y + 1.0f;
    std::memset(scanline, 0, w * sizeof(float));
    std::memset(scanline2, 0, (w + 1) * sizeof(float));
    for (Active** step = &active; *step;) {
      if ((*step)->ey <= scan_y_top)
        *step = (*step)->next;
      else
        step = &(*step)->next;
    }
    while (e->y0 <= scan_y_bottom) {
      if (e->y0 != e->y1) {
        Active* z = &pool[used++];
        float dxdy = (e->x1 - e->x0) / (e->y1 - e->y0);
        z->fdx = dxdy;
        z->fdy = dxdy != 0.0f ? (1.0f / dxdy) : 0.0f;
        z->fx = e->x0 + dxdy * (scan_y_top - e->y0);
        z->fx -= off_x;
        z->direction = e->invert ? 1.0f : -1.0f;
        z->sy = e->y0;
        z->ey = e->y1;
        if (j == 0 && off_y != 0 && z->ey < scan_y_top) z->ey = scan_y_top;
        z->next = active;
        active = z;
      }
      ++e;
    }
    if (active) fill_active(scanline, scanline2 + 1, w, active, scan_y_top);
    float sum = 0;
    for (int i = 0; i < w; ++i) {
      sum += scanline2[i];
      float k = scanline[i] + sum;
      k = (float)std::fabs(k) * 255 + 0.5f;
      int m = (int)k;
      if (m > 255) m = 255;
      out[j * w + i] = (uint8_t)m;
    }
    for (Active* z = active; z; z = z->next) z->fx += z->fdx;
  }
}

}  // namespace

extern "C" {

// The glyph bitmap's geometry for a font-unit box (x0, y0, x1, y1) at
// `scale`, pen at integer pixels: out = {ix0, iy0, w, h, margin}. The
// bitmap is (w + 2 margin) x (h + 2 margin); its top-left pixel lies at
// (pen_x + ix0 - margin, baseline + iy0 - margin).
void lh_text_box(int x0, int y0, int x1, int y1, float scale, int* out) {
  int ix0 = (int)std::floor((float)x0 * scale + 0.0f);
  int iy0 = (int)std::floor((float)(-y1) * scale + 0.0f);
  int ix1 = (int)std::ceil((float)x1 * scale + 0.0f);
  int iy1 = (int)std::ceil((float)(-y0) * scale + 0.0f);
  int w = ix1 - ix0, h = iy1 - iy0;
  int mw = (w + 9) / 10, mh = (h + 9) / 10;
  int margin = (mw > mh ? mw : mh) + 10;
  out[0] = ix0;
  out[1] = iy0;
  out[2] = w;
  out[3] = h;
  out[4] = margin;
}

// Coverage of an outline (`verts`: n rows of int16 type, x, y, cx, cy in
// font units, y up) into `out`, (h + 2 margin) rows of (w + 2 margin)
// bytes, with the geometry from lh_text_box. Returns 0, or -1 when the
// outline does not start with a move.
int lh_text_rasterize(const int16_t* verts, int nv, float scale, int ix0,
                      int iy0, int w, int h, int margin, uint8_t* out) {
  int bw = w + 2 * margin, bh = h + 2 * margin;
  std::memset(out, 0, (size_t)bw * bh);
  if (nv <= 0) return 0;
  if (verts[0] != kMove) return -1;
  float shift_x = (float)margin + 0.0f;
  float shift_y = 0.0f + (float)margin;
  float flat = 0.35f / scale;
  float flat2 = flat * flat;
  int n_contours = 0;
  for (int i = 0; i < nv; ++i) n_contours += verts[5 * i] == kMove;
  std::vector<int> lengths(n_contours);
  std::vector<Pt> pts;
  int n_points = 0;
  for (int pass = 0; pass < 2; ++pass) {
    float x = 0, y = 0;
    if (pass == 1) pts.resize(n_points > 0 ? n_points : 1);
    Pt* p = pass == 1 ? pts.data() : nullptr;
    n_points = 0;
    int n = -1, start = 0;
    for (int i = 0; i < nv; ++i) {
      const int16_t* v = verts + 5 * i;
      switch (v[0]) {
        case kMove:
          if (n >= 0) lengths[n] = n_points - start;
          ++n;
          start = n_points;
          x = v[1], y = v[2];
          add_point(p, n_points++, x, y);
          break;
        case kLine:
          x = v[1], y = v[2];
          add_point(p, n_points++, x, y);
          break;
        case kCurve:
          tesselate(p, &n_points, x, y, v[3], v[4], v[1], v[2], flat2, 0);
          x = v[1], y = v[2];
          break;
      }
    }
    lengths[n] = n_points - start;
  }
  float y_scale_inv = -scale;  // y up in the font, down in the image
  int n_edges = 0;
  for (int c = 0; c < n_contours; ++c) n_edges += lengths[c];
  std::vector<Edge> edges(n_edges + 1);
  n_edges = 0;
  int m = 0;
  for (int c = 0; c < n_contours; ++c) {
    const Pt* p = pts.data() + m;
    m += lengths[c];
    int j = lengths[c] - 1;
    for (int k = 0; k < lengths[c]; j = k++) {
      int a = k, b = j;
      if (p[j].y == p[k].y) continue;
      Edge& e = edges[n_edges];
      e.invert = 0;
      if (p[j].y > p[k].y) {
        e.invert = 1;
        a = j, b = k;
      }
      e.x0 = p[a].x * scale + shift_x;
      e.y0 = p[a].y * y_scale_inv + shift_y;
      e.x1 = p[b].x * scale + shift_x;
      e.y1 = p[b].y * y_scale_inv + shift_y;
      ++n_edges;
    }
  }
  sort_quick(edges.data(), n_edges);
  sort_insertion(edges.data(), n_edges);
  rasterize_sorted(out, bw, bh, edges.data(), n_edges, ix0, iy0);
  return 0;
}

// Blends `mask` (mh x mw coverage) at (x, y) into `img` (height x width x
// 3 u8, rows `stride` bytes apart) with colour `color` (3 bytes), cut to
// the image on every side. Pixels of coverage 0 are left as they are.
void lh_text_blend(uint8_t* img, int height, int width, long stride,
                   const uint8_t* mask, int mh, int mw, int x, int y,
                   const uint8_t* color) {
  int r0 = y < 0 ? -y : 0, c0 = x < 0 ? -x : 0;
  int r1 = mh < height - y ? mh : height - y;
  int c1 = mw < width - x ? mw : width - x;
  for (int r = r0; r < r1; ++r) {
    uint8_t* row = img + (long)(y + r) * stride;
    const uint8_t* m = mask + (long)r * mw;
    for (int c = c0; c < c1; ++c) {
      int a = m[c];
      if (!a) continue;
      uint8_t* px = row + (long)(x + c) * 3;
      for (int k = 0; k < 3; ++k)
        px[k] = (uint8_t)((px[k] * (255 - a) + color[k] * a + 127) / 255);
    }
  }
}

}  // extern "C"
