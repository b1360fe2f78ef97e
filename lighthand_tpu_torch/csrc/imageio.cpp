// Image codec and geometric resampling for the data readers, on the host.
//
// The counterpart of the OpenCV calls the JAX package's readers make
// (cv2.imread / cv2.imdecode with IMREAD_COLOR or IMREAD_GRAYSCALE,
// cv2.resize with INTER_LINEAR, cv2.warpAffine with INTER_LINEAR |
// WARP_INVERSE_MAP and a constant 0 border), written to give the same bytes:
//
// - baseline JPEG as libjpeg-turbo decodes it with its defaults: Huffman
//   decoding with restart intervals, the ISLOW integer IDCT (13-bit
//   constants, PASS1_BITS 2, the post-IDCT range-limit table), fancy
//   (triangle) upsampling for h2v1, h1v2 and h2v2 chroma, replication for
//   other ratios, and the fixed-point YCbCr -> RGB tables; the EXIF
//   orientation tag is read (and applied by the caller, as OpenCV does);
// - the PNG scanline filters (types 0-4) and the pixel transforms libpng
//   makes for OpenCV: 16-bit samples cut to their high byte, palette and
//   gray expanded to RGB, alpha stripped, and libpng's truncating
//   fixed-point rgb -> gray. The zlib stream is inflated by the caller;
// - resize: 11-bit fixed-point coefficients, the vertical pass in OpenCV's
//   16-bit vector arithmetic (which it also runs over the row's tail), and
//   the 2x2 box average where the scale is exactly 2 on both axes;
// - warpAffine: float32 source coordinates (fused multiply-add in the
//   16-pixel vector body, another association in the scalar tail), float32
//   bilinear blending with fused multiply-adds, pixels outside the image
//   read as 0, and rounding to nearest even.
//
// Refused: progressive, arithmetic-coded, lossless, hierarchical and
// 12-bit JPEGs, CMYK JPEGs; interlaced PNGs (checked by the caller).
//
// Plain C interface for ctypes; no call keeps state, so any number of
// threads may call at once (ctypes releases the GIL around each call).
// Build with -ffp-contract=off: the float arithmetic above is spelled out.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Fail {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Fail{msg}; }

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

// ---------------------------------------------------------------- JPEG ---

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries so a corrupt run length cannot index past the table
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  // canonical code tables (JPEG F.2.2.3)
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  uint8_t values[256];
  // 9-bit lookahead: (length << 8) | value, 0 when the code is longer
  uint16_t look[512];
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals,
                   int nvals) {
  std::memcpy(h.values, vals, static_cast<size_t>(nvals));
  std::memset(h.look, 0, sizeof(h.look));
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    h.valptr[len] = k;
    h.mincode[len] = code;
    int n = counts[len - 1];
    if (n) {
      if (code + n > (1 << len)) fail("bad Huffman table in JPEG data");
      for (int i = 0; i < n; ++i, ++k, ++code) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j) {
            h.look[(code << shift) | j] =
                static_cast<uint16_t>((len << 8) | vals[k]);
          }
        }
      }
      h.maxcode[len] = code - 1;
    } else {
      h.maxcode[len] = -1;
    }
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
}

// The orientation tag (0x0112) of a TIFF structure's first IFD, as EXIF
// stores it; 1 (as stored) where there is none or it is out of range.
int tiff_orientation(const uint8_t* t, size_t tn) {
  if (tn < 8) return 1;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') {
    le = true;
  } else if (t[0] == 'M' && t[1] == 'M') {
    le = false;
  } else {
    return 1;
  }
  auto rd16 = [&](size_t o) -> uint32_t {
    return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
  };
  auto rd32 = [&](size_t o) -> uint32_t {
    return le ? (rd16(o) | (rd16(o + 2) << 16))
              : ((rd16(o) << 16) | rd16(o + 2));
  };
  if (rd16(2) != 42) return 1;
  size_t ifd = rd32(4);
  if (ifd + 2 > tn) return 1;
  uint32_t count = rd16(ifd);
  for (uint32_t i = 0; i < count; ++i) {
    size_t e = ifd + 2 + 12 * static_cast<size_t>(i);
    if (e + 12 > tn) return 1;
    if (rd16(e) == 0x0112 && rd16(e + 2) == 3) {
      uint32_t v = rd16(e + 8);
      return v >= 1 && v <= 8 ? static_cast<int>(v) : 1;
    }
  }
  return 1;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;          // Huffman tables of the current scan
  int bw = 0, bh = 0;          // blocks stored per row / column (padded)
  int dw = 0, dh = 0;          // downsampled width / height in samples
  int dc_pred = 0;
  std::vector<int16_t> coef;   // bh * bw blocks of 64, natural order
};

struct Jpeg {
  const uint8_t* data = nullptr;
  size_t n = 0, pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0;
  Component comp[4];
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  int orientation = 1;
  int adobe_transform = -1;
  bool seen_sof = false, seen_jfif = false;

  // bit reader over the entropy-coded segment
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;

  uint8_t byte() {
    if (pos >= n) fail("truncated JPEG data");
    return data[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void fill_bits() {
    while (bitcnt <= 24) {
      uint32_t b = 0;
      if (!hit_marker && pos < n) {
        b = data[pos];
        if (b == 0xFF) {
          uint8_t next = pos + 1 < n ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // leave the marker for the parser
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      bitbuf |= b << (24 - bitcnt);
      bitcnt += 8;
    }
  }

  int get_bits(int k) {
    if (k == 0) return 0;
    if (bitcnt < k) fill_bits();
    int v = static_cast<int>(bitbuf >> (32 - k));
    bitbuf <<= k;
    bitcnt -= k;
    return v;
  }

  int decode(const Huffman& h) {
    if (bitcnt < 16) fill_bits();
    uint16_t e = h.look[bitbuf >> 23];
    if (e) {
      int len = e >> 8;
      bitbuf <<= len;
      bitcnt -= len;
      return e & 0xFF;
    }
    int len = 10;
    int32_t code = static_cast<int32_t>(bitbuf >> (32 - len));
    while (len <= 16 && code > h.maxcode[len]) {
      ++len;
      code = static_cast<int32_t>(bitbuf >> (32 - len));
    }
    if (len > 16) fail("corrupt Huffman code in JPEG data");
    bitbuf <<= len;
    bitcnt -= len;
    return h.values[h.valptr[len] + code - h.mincode[len]];
  }

  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  void reset_bits() {
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
  }

  void read_exif(size_t start, size_t len) {
    if (len < 14 || std::memcmp(data + start, "Exif\0\0", 6) != 0) return;
    orientation = tiff_orientation(data + start + 6, len - 6);
  }

  void read_sof(int marker, int len) {
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA ||
        marker == 0xCE) {
      fail("progressive JPEG is not supported");
    }
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB ||
        marker == 0xCF) {
      fail("lossless JPEG is not supported");
    }
    if (marker >= 0xC9) fail("arithmetic-coded JPEG is not supported");
    if (marker == 0xC5) fail("hierarchical JPEG is not supported");
    int precision = byte();
    if (precision != 8) {
      fail(std::to_string(precision) + "-bit JPEG is not supported");
    }
    height = u16();
    width = u16();
    ncomp = byte();
    if (width <= 0 || height <= 0) fail("JPEG without a frame size");
    if (ncomp != 1 && ncomp != 3) {
      fail(std::to_string(ncomp) + "-component JPEG is not supported");
    }
    if (len != 8 + 3 * ncomp) fail("bad SOF length");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) {
        fail("bad JPEG component parameters");
      }
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1)
                              / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1)
                              / vmax);
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    seen_sof = true;
  }

  void read_dqt(int len) {
    size_t end = pos + static_cast<size_t>(len) - 2;
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad DQT");
      for (int k = 0; k < 64; ++k) {
        qt[tq][kZigzag[k]] = static_cast<uint16_t>(pq ? u16() : byte());
      }
      qt_defined[tq] = true;
    }
  }

  void read_dht(int len) {
    size_t end = pos + static_cast<size_t>(len) - 2;
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        counts[i] = byte();
        total += counts[i];
      }
      if (total > 256 || pos + static_cast<size_t>(total) > n) {
        fail("bad DHT");
      }
      build_huffman(tc ? ac[th] : dc[th], counts, data + pos, total);
      pos += static_cast<size_t>(total);
    }
  }

  void decode_block(Component& c, int16_t* blk) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = decode(hd);
    if (s > 16) fail("corrupt JPEG data");
    int diff = s ? extend(get_bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      int rs = decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = static_cast<int16_t>(extend(get_bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // Skip to the next RSTn marker and consume it (libjpeg's process_restart
  // for a well-formed stream).
  void restart() {
    reset_bits();
    while (pos + 1 < n) {
      if (data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) {
        pos += 2;
        break;
      }
      if (data[pos] == 0xFF && data[pos + 1] != 0 && data[pos + 1] != 0xFF) {
        break;  // another marker: leave it to the parser
      }
      ++pos;
    }
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
  }

  void read_sos() {
    if (!seen_sof) fail("SOS before SOF");
    int ns = byte();
    if (ns < 1 || ns > ncomp) fail("bad SOS");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = byte();
      int tables = byte();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j) {
        if (comp[j].id == id) c = &comp[j];
      }
      if (!c) fail("SOS names an unknown component");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined ||
          !ac[c->ta].defined) {
        fail("SOS names an undefined Huffman table");
      }
      sc[i] = c;
    }
    int ss = byte(), se = byte(), ah_al = byte();
    if (ss != 0 || se != 63 || ah_al != 0) {
      fail("progressive JPEG is not supported");
    }
    reset_bits();
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
    int todo = restart_interval;
    if (ns == 1) {
      Component& c = *sc[0];
      int bx = (c.dw + 7) / 8, by = (c.dh + 7) / 8;
      for (int y = 0; y < by; ++y) {
        for (int x = 0; x < bx; ++x) {
          if (restart_interval && todo == 0) {
            restart();
            todo = restart_interval;
          }
          decode_block(c, &c.coef[(static_cast<size_t>(y) * c.bw + x) * 64]);
          --todo;
        }
      }
    } else {
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval && todo == 0) {
            restart();
            todo = restart_interval;
          }
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v) {
              for (int h = 0; h < c.h; ++h) {
                size_t row = static_cast<size_t>(my) * c.v + v;
                size_t col = static_cast<size_t>(mx) * c.h + h;
                decode_block(c, &c.coef[(row * c.bw + col) * 64]);
              }
            }
          }
          --todo;
        }
      }
    }
    // move to the marker after the entropy-coded segment
    reset_bits();
    while (pos + 1 < n &&
           !(data[pos] == 0xFF && data[pos + 1] != 0 &&
             !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) &&
             data[pos + 1] != 0xFF)) {
      ++pos;
    }
  }

  // Parse markers; with `headers_only` stop at the first SOS.
  void parse(bool headers_only) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG");
    pos = 2;
    bool seen_sos = false;
    while (pos < n) {
      if (byte() != 0xFF) continue;  // tolerate garbage between markers
      int marker = byte();
      while (marker == 0xFF) marker = byte();
      if (marker == 0xD9) break;
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      int len = u16();
      if (len < 2 || pos + static_cast<size_t>(len) - 2 > n) {
        fail("bad JPEG marker length");
      }
      size_t next = pos + static_cast<size_t>(len) - 2;
      if (marker == 0xDA) {
        if (headers_only) return;
        read_sos();
        seen_sos = true;
        continue;
      }
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
          marker != 0xC8 && marker != 0xCC) {
        if (seen_sof) fail("JPEG with more than one frame");
        read_sof(marker, len);
      } else if (marker == 0xC4) {
        read_dht(len);
      } else if (marker == 0xCC) {
        fail("arithmetic-coded JPEG is not supported");
      } else if (marker == 0xDB) {
        read_dqt(len);
      } else if (marker == 0xDD) {
        restart_interval = u16();
      } else if (marker == 0xE1) {
        if (orientation == 1) read_exif(pos, static_cast<size_t>(len) - 2);
      } else if (marker == 0xE0) {
        if (len >= 7 && std::memcmp(data + pos, "JFIF\0", 5) == 0) {
          seen_jfif = true;
        }
      } else if (marker == 0xEE) {
        if (len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
          adobe_transform = data[pos + 11];
        }
      }
      pos = next;
    }
    if (!seen_sof) fail("JPEG without a frame header");
    if (!headers_only && !seen_sos) fail("JPEG without scan data");
  }
};

// libjpeg-turbo's jidctint.c (jpeg_idct_islow), with jdmaster.c's range
// limit table for the output.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) {
        t[i] = static_cast<uint8_t>(128 + i);
      } else if (i < 512) {
        t[i] = 255;
      } else if (i < 896) {
        t[i] = 0;
      } else {
        t[i] = static_cast<uint8_t>(i - 896);
      }
    }
  }
};

const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int32_t dc = (static_cast<int32_t>(ip[0]) * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16];
    int64_t z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = static_cast<int32_t>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int32_t>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int32_t>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int32_t>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int32_t>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int32_t>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int32_t>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int32_t>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// One component's samples after the IDCT, padded to whole blocks.
struct Plane {
  int w = 0, h = 0;  // valid (downsampled) size
  int stride = 0;
  std::vector<uint8_t> px;
  int at(int y, int x) const {
    return px[static_cast<size_t>(y) * stride + x];
  }
};

Plane idct_component(const Component& c, const uint16_t* q) {
  Plane p;
  p.w = c.dw;
  p.h = c.dh;
  p.stride = c.bw * 8;
  p.px.assign(static_cast<size_t>(p.stride) * c.bh * 8, 0);
  int bx = (c.dw + 7) / 8, by = (c.dh + 7) / 8;
  for (int y = 0; y < by; ++y) {
    for (int x = 0; x < bx; ++x) {
      idct_islow(&c.coef[(static_cast<size_t>(y) * c.bw + x) * 64], q,
                 &p.px[static_cast<size_t>(y) * 8 * p.stride + x * 8],
                 p.stride);
    }
  }
  return p;
}

// libjpeg-turbo's jdsample.c: the component upsampled to the image size.
// Context rows and columns past the component's edge repeat its last row
// or column (jdmainct.c's set_bottom_pointers, the first/last column cases).
std::vector<uint8_t> upsample(const Plane& p, int hf, int vf, int width,
                              int height) {
  std::vector<uint8_t> out(static_cast<size_t>(width) * height);
  auto clampy = [&](int y) { return y < 0 ? 0 : (y >= p.h ? p.h - 1 : y); };
  auto clampx = [&](int x) { return x < 0 ? 0 : (x >= p.w ? p.w - 1 : x); };
  if (hf == 1 && vf == 1) {
    for (int y = 0; y < height; ++y) {
      std::memcpy(&out[static_cast<size_t>(y) * width],
                  &p.px[static_cast<size_t>(y) * p.stride],
                  static_cast<size_t>(width));
    }
  } else if (hf == 2 && vf == 1 && p.w > 2) {
    for (int y = 0; y < height; ++y) {
      uint8_t* o = &out[static_cast<size_t>(y) * width];
      for (int ox = 0; ox < width; ++ox) {
        int x = ox >> 1;
        int c3 = p.at(y, x) * 3;
        o[ox] = static_cast<uint8_t>(
            (ox & 1) ? (c3 + p.at(y, clampx(x + 1)) + 2) >> 2
                     : (c3 + p.at(y, clampx(x - 1)) + 1) >> 2);
      }
    }
  } else if (hf == 1 && vf == 2) {
    for (int oy = 0; oy < height; ++oy) {
      int y = oy >> 1;
      int y1 = clampy((oy & 1) ? y + 1 : y - 1);
      int bias = (oy & 1) ? 2 : 1;
      uint8_t* o = &out[static_cast<size_t>(oy) * width];
      for (int x = 0; x < width; ++x) {
        o[x] = static_cast<uint8_t>((p.at(y, x) * 3 + p.at(y1, x) + bias)
                                    >> 2);
      }
    }
  } else if (hf == 2 && vf == 2 && p.w > 2) {
    std::vector<int> cs(static_cast<size_t>(p.w));
    for (int oy = 0; oy < height; ++oy) {
      int y = oy >> 1;
      int y1 = clampy((oy & 1) ? y + 1 : y - 1);
      for (int x = 0; x < p.w; ++x) cs[x] = p.at(y, x) * 3 + p.at(y1, x);
      uint8_t* o = &out[static_cast<size_t>(oy) * width];
      for (int ox = 0; ox < width; ++ox) {
        int x = ox >> 1;
        int c3 = cs[x] * 3;
        o[ox] = static_cast<uint8_t>(
            (ox & 1) ? (c3 + cs[clampx(x + 1)] + 7) >> 4
                     : (c3 + cs[clampx(x - 1)] + 8) >> 4);
      }
    }
  } else {
    // int_upsample / h2v1_upsample / h2v2_upsample: replication
    for (int oy = 0; oy < height; ++oy) {
      uint8_t* o = &out[static_cast<size_t>(oy) * width];
      for (int ox = 0; ox < width; ++ox) {
        o[ox] = static_cast<uint8_t>(p.at(oy / vf, ox / hf));
      }
    }
  }
  return out;
}

// jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t{1} << 15;
    auto fix = [](double v) {
      return static_cast<int64_t>(v * (1 << 16) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// The image as stored (before its EXIF orientation) into `out`.
void jpeg_decode(const uint8_t* data, size_t n, int gray, uint8_t* out,
                 int out_h, int out_w) {
  Jpeg j;
  j.data = data;
  j.n = n;
  j.parse(false);
  const int W = j.width, H = j.height;
  for (int i = 0; i < j.ncomp; ++i) {
    if (!j.qt_defined[j.comp[i].tq]) fail("JPEG without quantization table");
  }
  int c_out = gray ? 1 : 3;
  std::vector<uint8_t> img(static_cast<size_t>(W) * H * c_out);
  auto plane = [&](int i) {
    const Component& c = j.comp[i];
    Plane p = idct_component(c, j.qt[c.tq]);
    return upsample(p, j.hmax / c.h, j.vmax / c.v, W, H);
  };
  if (j.ncomp == 1 || gray) {
    if (j.hmax % j.comp[0].h || j.vmax % j.comp[0].v) {
      fail("unsupported JPEG sampling factors");
    }
    std::vector<uint8_t> y = plane(0);
    if (gray) {
      img = y;
    } else {
      for (size_t k = 0; k < y.size(); ++k) {
        img[3 * k] = img[3 * k + 1] = img[3 * k + 2] = y[k];
      }
    }
  } else {
    for (int i = 0; i < 3; ++i) {
      if (j.hmax % j.comp[i].h || j.vmax % j.comp[i].v) {
        fail("unsupported JPEG sampling factors");
      }
    }
    std::vector<uint8_t> p0 = plane(0), p1 = plane(1), p2 = plane(2);
    // jdapimin.c's default_decompress_parms: an Adobe marker's transform
    // flag decides; without one, a JFIF marker or ids other than R, G, B
    // mean YCbCr
    bool rgb;
    if (j.adobe_transform >= 0) {
      rgb = j.adobe_transform == 0;
    } else {
      rgb = !j.seen_jfif && j.comp[0].id == 'R' && j.comp[1].id == 'G' &&
            j.comp[2].id == 'B';
    }
    for (size_t k = 0; k < p0.size(); ++k) {
      if (rgb) {
        img[3 * k] = p0[k];
        img[3 * k + 1] = p1[k];
        img[3 * k + 2] = p2[k];
        continue;
      }
      int y = p0[k], cb = p1[k], cr = p2[k];
      img[3 * k] = clamp255(y + kYcc.cr_r[cr]);
      img[3 * k + 1] = clamp255(
          y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      img[3 * k + 2] = clamp255(y + kYcc.cb_b[cb]);
    }
  }
  if (H != out_h || W != out_w) fail("output size mismatch");
  std::memcpy(out, img.data(), img.size());
}

// ----------------------------------------------------------------- PNG ---

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

void png_unfilter(uint8_t* raw, size_t n, int w, int h, int depth,
                  int color_type) {
  int channels = color_type == 0 ? 1 : color_type == 2 ? 3
               : color_type == 3 ? 1 : color_type == 4 ? 2 : 4;
  size_t rowbytes = (static_cast<size_t>(w) * channels * depth + 7) / 8;
  int bpp = std::max(1, channels * depth / 8);
  if (n < (rowbytes + 1) * static_cast<size_t>(h)) fail("truncated PNG data");
  uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw + static_cast<size_t>(y) * (rowbytes + 1);
    int ft = row[0];
    uint8_t* cur = row + 1;
    for (size_t i = 0; i < rowbytes; ++i) {
      int a = i >= static_cast<size_t>(bpp) ? cur[i - bpp] : 0;
      int b = prev ? prev[i] : 0;
      int c = (prev && i >= static_cast<size_t>(bpp)) ? prev[i - bpp] : 0;
      int v = cur[i];
      switch (ft) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) >> 1; break;
        case 4: v += paeth(a, b, c); break;
        default: fail("bad PNG filter type " + std::to_string(ft));
      }
      cur[i] = static_cast<uint8_t>(v);
    }
    prev = cur;
  }
}

void png_convert(const uint8_t* raw, int w, int h, int depth, int color_type,
                 const uint8_t* palette, int npal, int gray, uint8_t* out) {
  int channels = color_type == 0 ? 1 : color_type == 2 ? 3
               : color_type == 3 ? 1 : color_type == 4 ? 2 : 4;
  size_t rowbytes = (static_cast<size_t>(w) * channels * depth + 7) / 8;
  // libpng's rgb -> gray coefficients for OpenCV's (0.299, 0.587)
  const uint32_t rc = 9797, gc = 19234, bc = 32768 - rc - gc;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = raw + static_cast<size_t>(y) * (rowbytes + 1) + 1;
    for (int x = 0; x < w; ++x) {
      // sample k of pixel x, as a 16-bit value where depth is 16
      auto sample = [&](int k) -> uint32_t {
        if (depth == 16) {
          size_t o = (static_cast<size_t>(x) * channels + k) * 2;
          return (static_cast<uint32_t>(row[o]) << 8) | row[o + 1];
        }
        if (depth == 8) return row[static_cast<size_t>(x) * channels + k];
        size_t bit = static_cast<size_t>(x) * depth;
        int shift = 8 - depth - static_cast<int>(bit % 8);
        return (row[bit / 8] >> shift) & ((1u << depth) - 1);
      };
      uint32_t r, g, b;
      bool color = color_type == 2 || color_type == 6 || color_type == 3;
      if (color_type == 3) {
        uint32_t idx = sample(0);
        if (static_cast<int>(idx) >= npal) fail("PNG palette index out of range");
        r = palette[3 * idx];
        g = palette[3 * idx + 1];
        b = palette[3 * idx + 2];
      } else if (color) {
        r = sample(0);
        g = sample(1);
        b = sample(2);
      } else {
        r = sample(0);
        if (depth < 8) r *= 255u / ((1u << depth) - 1);
        g = b = r;
      }
      int eff_depth = color_type == 3 ? 8 : (depth == 16 ? 16 : 8);
      uint8_t* o = out + static_cast<size_t>(y) * w * (gray ? 1 : 3)
                   + static_cast<size_t>(x) * (gray ? 1 : 3);
      if (gray) {
        uint32_t v;
        if (!color || (r == g && r == b)) {
          v = r;
        } else if (eff_depth == 16) {
          v = (rc * r + gc * g + bc * b + 16384) >> 15;
        } else {
          v = (rc * r + gc * g + bc * b) >> 15;
        }
        o[0] = static_cast<uint8_t>(eff_depth == 16 ? v >> 8 : v);
      } else if (eff_depth == 16) {
        o[0] = static_cast<uint8_t>(r >> 8);
        o[1] = static_cast<uint8_t>(g >> 8);
        o[2] = static_cast<uint8_t>(b >> 8);
      } else {
        o[0] = static_cast<uint8_t>(r);
        o[1] = static_cast<uint8_t>(g);
        o[2] = static_cast<uint8_t>(b);
      }
    }
  }
}

// -------------------------------------------------------------- resize ---

inline int16_t sat16(int32_t v) {
  return static_cast<int16_t>(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
}

// OpenCV's fixed-point coefficients along one axis (resize.cpp,
// resizeGeneric_'s setup for INTER_LINEAR on 8-bit data).
void linear_coeffs(int src, int dst, bool clamp, std::vector<int>& ofs,
                   std::vector<int>& w0, std::vector<int>& w1) {
  double scale = static_cast<double>(src) / dst;
  ofs.resize(dst);
  w0.resize(dst);
  w1.resize(dst);
  for (int d = 0; d < dst; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= static_cast<float>(s);
    if (clamp) {
      if (s < 0) {
        f = 0.f;
        s = 0;
      }
      if (s >= src - 1) {
        f = 0.f;
        s = src - 1;
      }
    }
    ofs[d] = s;
    w0[d] = static_cast<int>(std::nearbyint((1.f - f) * 2048.f));
    w1[d] = static_cast<int>(std::nearbyint(f * 2048.f));
  }
}

void resize_linear(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                   int H, int W) {
  if (h == H && w == W) {
    std::memcpy(dst, src, static_cast<size_t>(h) * w * c);
    return;
  }
  if (h == 2 * H && w == 2 * W) {
    // INTER_AREA's fast path, which cv::resize takes for INTER_LINEAR here
    for (int y = 0; y < H; ++y) {
      const uint8_t* r0 = src + static_cast<size_t>(2 * y) * w * c;
      const uint8_t* r1 = r0 + static_cast<size_t>(w) * c;
      uint8_t* o = dst + static_cast<size_t>(y) * W * c;
      for (int x = 0; x < W; ++x) {
        for (int k = 0; k < c; ++k) {
          int s = r0[2 * x * c + k] + r0[(2 * x + 1) * c + k] +
                  r1[2 * x * c + k] + r1[(2 * x + 1) * c + k];
          o[x * c + k] = static_cast<uint8_t>((s + 2) >> 2);
        }
      }
    }
    return;
  }
  std::vector<int> xo, a0, a1, yo, b0, b1;
  linear_coeffs(w, W, true, xo, a0, a1);
  linear_coeffs(h, H, false, yo, b0, b1);
  const int width = W * c;
  // horizontal pass of every source row, as 32-bit sums
  std::vector<int32_t> hor(static_cast<size_t>(h) * width);
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + static_cast<size_t>(y) * w * c;
    int32_t* o = &hor[static_cast<size_t>(y) * width];
    for (int x = 0; x < W; ++x) {
      int sx = xo[x];
      int sx1 = sx + 1 < w ? sx + 1 : w - 1;
      for (int k = 0; k < c; ++k) {
        o[x * c + k] = s[sx * c + k] * a0[x] + s[sx1 * c + k] * a1[x];
      }
    }
  }
  for (int y = 0; y < H; ++y) {
    int r0 = yo[y] < 0 ? 0 : (yo[y] >= h ? h - 1 : yo[y]);
    int r1 = yo[y] + 1 < 0 ? 0 : (yo[y] + 1 >= h ? h - 1 : yo[y] + 1);
    const int32_t* s0 = &hor[static_cast<size_t>(r0) * width];
    const int32_t* s1 = &hor[static_cast<size_t>(r1) * width];
    const int32_t bb0 = b0[y], bb1 = b1[y];
    uint8_t* o = dst + static_cast<size_t>(y) * width;
    for (int x = 0; x < width; ++x) {
      // VResizeLinearVec_32s8u: >> 4, pack to int16, mulhi, saturating
      // add, rounding shift by 2 and a saturating pack to uint8
      int32_t m0 = (static_cast<int32_t>(sat16(s0[x] >> 4)) * bb0) >> 16;
      int32_t m1 = (static_cast<int32_t>(sat16(s1[x] >> 4)) * bb1) >> 16;
      int32_t v = sat16(m0 + m1);
      o[x] = clamp255((v + 2) >> 2);
    }
  }
}

// --------------------------------------------------------- warp affine ---

void warp_affine_inverse(const uint8_t* src, int h, int w, int c,
                         const double* m, uint8_t* dst, int H, int W) {
  const float M0 = static_cast<float>(m[0]), M1 = static_cast<float>(m[1]),
              M2 = static_cast<float>(m[2]), M3 = static_cast<float>(m[3]),
              M4 = static_cast<float>(m[4]), M5 = static_cast<float>(m[5]);
  const int body = W / 16 * 16;
  auto px = [&](int y, int x, int k) -> float {
    if (x < 0 || x >= w || y < 0 || y >= h) return 0.f;
    return static_cast<float>(src[(static_cast<size_t>(y) * w + x) * c + k]);
  };
  for (int y = 0; y < H; ++y) {
    const float fy = static_cast<float>(y);
    const float mx = fy * M1 + M2, my = fy * M4 + M5;
    const float ymx = fy * M1, ymy = fy * M4;
    for (int x = 0; x < W; ++x) {
      const float fx = static_cast<float>(x);
      float sx, sy;
      if (x < body) {
        sx = std::fmaf(M0, fx, mx);
        sy = std::fmaf(M3, fx, my);
      } else {
        sx = std::fmaf(fx, M0, ymx) + M2;
        sy = std::fmaf(fx, M3, ymy) + M5;
      }
      const float flx = std::floor(sx), fly = std::floor(sy);
      const int ix = static_cast<int>(flx), iy = static_cast<int>(fly);
      const float a = sx - flx, b = sy - fly;
      uint8_t* o = dst + (static_cast<size_t>(y) * W + x) * c;
      for (int k = 0; k < c; ++k) {
        float p00 = px(iy, ix, k), p01 = px(iy, ix + 1, k);
        float p10 = px(iy + 1, ix, k), p11 = px(iy + 1, ix + 1, k);
        float v0 = std::fmaf(a, p01 - p00, p00);
        float v1 = std::fmaf(a, p11 - p10, p10);
        float v = std::fmaf(b, v1 - v0, v0);
        o[k] = clamp255(static_cast<int>(std::nearbyint(v)));
      }
    }
  }
}

// ------------------------------------------------------------ JPEG out ---
//
// Baseline JPEG as OpenCV's imencode / imwrite writes it through
// libjpeg-turbo with its defaults: JFIF 1.1 APP0 (no density unit, 1:1),
// one DQT marker per table, SOF0, the four (two for gray) standard
// Huffman tables of JPEG Annex K in one DHT marker each, one interleaved
// scan without restart intervals, then EOI. Colour images are YCbCr 4:2:0
// with the fixed-point RGB -> YCbCr of jccolor.c, h2v2 downsampling with
// its alternating 1/2 rounding bias, and edge replication to whole blocks;
// gray images are one component. The forward DCT is jfdctint.c's ISLOW,
// quantized as libjpeg-turbo's reciprocal multiply does it; blocks that
// only fill an MCU are zero with the previous block's DC.

const uint16_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint16_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 tables: 16 code counts, then the symbols.
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Code and length per symbol of a table given by counts (JPEG C.2).
struct HuffCodes {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
  HuffCodes(const uint8_t* bits, const uint8_t* vals) {
    uint16_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[vals[k]] = c++;
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c = static_cast<uint16_t>(c << 1);
    }
  }
};

const HuffCodes kDcLuma(kDcLumaBits, kDcVals);
const HuffCodes kAcLuma(kAcLumaBits, kAcLumaVals);
const HuffCodes kDcChroma(kDcChromaBits, kDcVals);
const HuffCodes kAcChroma(kAcChromaBits, kAcChromaVals);

// jpeg_set_quality(q, force_baseline=TRUE): jpeg_quality_scaling, then
// jpeg_add_quant_table's rounding and clamping to [1, 255].
void scale_quant(const uint16_t* base, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const int32_t scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    int32_t t = (static_cast<int32_t>(base[i]) * scale + 50) / 100;
    out[i] = static_cast<uint16_t>(std::clamp(t, 1, 255));
  }
}

// libjpeg-turbo's compute_reciprocal for a 16-bit DCTELEM: x / d rounded
// to nearest as ((x + corr) * recip) >> shift.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t d) {
  int b = 31 - __builtin_clz(d);  // floor(log2 d); d >= 8 here
  int r = 16 + b;
  uint32_t fq = (uint32_t{1} << r) / d, fr = (uint32_t{1} << r) % d;
  uint32_t c = d / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= d / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

// jfdctint.c's jpeg_fdct_islow on level-shifted samples, in place; the
// outputs are scaled up by 8.
void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, next = pass == 0 ? 8 : 1;
    for (int i = 0; i < 8; ++i) {
      int32_t* p = d + i * next;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step];
      int64_t tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step];
      int64_t tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      // pass 1 keeps PASS1_BITS of fraction; pass 2 removes them
      const int even = pass == 0 ? 0 : kPass1Bits;
      const int odd = pass == 0 ? kConstBits - kPass1Bits
                                : kConstBits + kPass1Bits;
      if (pass == 0) {
        p[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4 * step] =
            static_cast<int32_t>((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        p[0] = static_cast<int32_t>(descale(tmp10 + tmp11, even));
        p[4 * step] = static_cast<int32_t>(descale(tmp10 - tmp11, even));
      }
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] =
          static_cast<int32_t>(descale(z1 + tmp13 * FIX_0_765366865, odd));
      p[6 * step] =
          static_cast<int32_t>(descale(z1 + tmp12 * -FIX_1_847759065, odd));

      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 = z3 * -FIX_1_961570560 + z5;
      z4 = z4 * -FIX_0_390180644 + z5;
      p[7 * step] = static_cast<int32_t>(descale(tmp4 + z1 + z3, odd));
      p[5 * step] = static_cast<int32_t>(descale(tmp5 + z2 + z4, odd));
      p[3 * step] = static_cast<int32_t>(descale(tmp6 + z2 + z3, odd));
      p[step] = static_cast<int32_t>(descale(tmp7 + z1 + z4, odd));
    }
  }
}

// One component's samples, already padded by edge replication to whole
// blocks (bw x bh blocks), and the quantized blocks the scan reads.
struct EncPlane {
  int bw = 0, bh = 0;
  std::vector<uint8_t> px;  // (bh*8) x (bw*8)
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order

  void quantize(const uint16_t* q) {
    Divisor div[64];
    for (int i = 0; i < 64; ++i) div[i] = reciprocal(uint32_t{q[i]} << 3);
    const int stride = bw * 8;
    coef.assign(static_cast<size_t>(bw) * bh * 64, 0);
    int32_t ws[64];
    for (int by = 0; by < bh; ++by) {
      for (int bx = 0; bx < bw; ++bx) {
        for (int y = 0; y < 8; ++y) {
          const uint8_t* row =
              px.data() + static_cast<size_t>(by * 8 + y) * stride + bx * 8;
          for (int x = 0; x < 8; ++x) ws[y * 8 + x] = row[x] - 128;
        }
        fdct_islow(ws);
        int16_t* out = coef.data() + (static_cast<size_t>(by) * bw + bx) * 64;
        for (int i = 0; i < 64; ++i) {
          const uint32_t a = static_cast<uint32_t>(std::abs(ws[i]));
          const int32_t v = static_cast<int32_t>(
              (static_cast<uint64_t>(a + div[i].corr) * div[i].recip) >>
              div[i].shift);
          out[i] = static_cast<int16_t>(ws[i] < 0 ? -v : v);
        }
      }
    }
  }
};

// Replicate the last column and row of a w x h plane out to W x H.
EncPlane pad_plane(std::vector<uint8_t> src, int w, int h, int bw, int bh) {
  EncPlane p;
  p.bw = bw;
  p.bh = bh;
  const int W = bw * 8, H = bh * 8;
  p.px.resize(static_cast<size_t>(W) * H);
  for (int y = 0; y < H; ++y) {
    const uint8_t* s = src.data() + static_cast<size_t>(std::min(y, h - 1)) * w;
    uint8_t* d = p.px.data() + static_cast<size_t>(y) * W;
    std::memcpy(d, s, static_cast<size_t>(w));
    std::memset(d + w, s[w - 1], static_cast<size_t>(W - w));
  }
  return p;
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((uint32_t{1} << size) - 1));
    bits_ += size;
    while (bits_ >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc_ >> (bits_ - 8));
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);  // byte stuffing
      bits_ -= 8;
    }
    acc_ &= (uint64_t{1} << bits_) - 1;
  }
  void flush() {  // pad the last byte with 1 bits
    if (bits_ > 0) put(0x7F, 8 - bits_);
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int bits_ = 0;
};

inline int nbits(uint32_t v) { return v == 0 ? 0 : 32 - __builtin_clz(v); }

// jchuff.c's encode_one_block.
void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc,
                  const HuffCodes& dc, const HuffCodes& ac) {
  int t = blk[0] - last_dc, t2 = t;
  last_dc = blk[0];
  if (t < 0) {
    t = -t;
    --t2;
  }
  int n = nbits(static_cast<uint32_t>(t));
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put(static_cast<uint32_t>(t2), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    t = blk[kZigzag[k]];
    if (t == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    t2 = t;
    if (t < 0) {
      t = -t;
      --t2;
    }
    n = nbits(static_cast<uint32_t>(t));
    const int sym = (run << 4) + n;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(t2), n);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits,
             const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + n);
  o.push_back(static_cast<uint8_t>(cls_id));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

// fixed-point RGB -> YCbCr of jccolor.c (SCALEBITS 16)
constexpr int kScaleBits = 16;
constexpr int32_t fix16(double x) {
  return static_cast<int32_t>(x * (1 << kScaleBits) + 0.5);
}
constexpr int32_t kOneHalf = 1 << (kScaleBits - 1);
constexpr int32_t kCbCrOffset = 128 << kScaleBits;

std::vector<uint8_t> jpeg_encode(const uint8_t* img, int h, int w, int c,
                                 int quality) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535 || (c != 1 && c != 3)) {
    fail("jpeg_encode: unsupported image " + std::to_string(w) + "x" +
         std::to_string(h) + "x" + std::to_string(c));
  }
  uint16_t qt[2][64];
  scale_quant(kStdLumaQ, quality, qt[0]);
  scale_quant(kStdChromaQ, quality, qt[1]);
  const size_t n = static_cast<size_t>(h) * w;
  const bool color = c == 3;
  // the MCU is 16x16 pixels for colour (4:2:0), 8x8 for gray
  const int mcu = color ? 16 : 8;
  const int mcu_w = (w + mcu - 1) / mcu, mcu_h = (h + mcu - 1) / mcu;
  std::vector<EncPlane> planes;
  if (!color) {
    planes.push_back(pad_plane(std::vector<uint8_t>(img, img + n), w, h,
                               mcu_w, mcu_h));
  } else {
    std::vector<uint8_t> y(n), cb(n), cr(n);
    for (size_t i = 0; i < n; ++i) {
      const int32_t r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
      y[i] = static_cast<uint8_t>(
          (fix16(0.29900) * r + fix16(0.58700) * g + fix16(0.11400) * b +
           kOneHalf) >> kScaleBits);
      cb[i] = static_cast<uint8_t>(
          (-fix16(0.16874) * r - fix16(0.33126) * g + fix16(0.50000) * b +
           kCbCrOffset + kOneHalf - 1) >> kScaleBits);
      cr[i] = static_cast<uint8_t>(
          (fix16(0.50000) * r - fix16(0.41869) * g - fix16(0.08131) * b +
           kCbCrOffset + kOneHalf - 1) >> kScaleBits);
    }
    // luma: whole blocks (ceil(w/8) x ceil(h/8)); chroma: h2v2 over the
    // rows and columns replicated out to whole 16-pixel MCUs
    planes.push_back(pad_plane(std::move(y), w, h, (w + 7) / 8, (h + 7) / 8));
    const int W2 = mcu_w * 16, hs = (h + 1) / 2;
    for (const std::vector<uint8_t>* full : {&cb, &cr}) {
      std::vector<uint8_t> ds(static_cast<size_t>(mcu_w) * 8 * hs);
      for (int oy = 0; oy < hs; ++oy) {
        const uint8_t* r0 =
            full->data() + static_cast<size_t>(2 * oy) * w;
        const uint8_t* r1 =
            full->data() + static_cast<size_t>(std::min(2 * oy + 1, h - 1)) * w;
        int bias = 1;  // 1, 2, 1, 2, ... along the row
        for (int ox = 0; ox < W2 / 2; ++ox) {
          const int x0 = std::min(2 * ox, w - 1), x1 = std::min(2 * ox + 1, w - 1);
          ds[static_cast<size_t>(oy) * (W2 / 2) + ox] = static_cast<uint8_t>(
              (r0[x0] + r0[x1] + r1[x0] + r1[x1] + bias) >> 2);
          bias ^= 3;
        }
      }
      planes.push_back(pad_plane(std::move(ds), W2 / 2, hs, mcu_w, mcu_h));
    }
  }
  for (size_t i = 0; i < planes.size(); ++i) {
    planes[i].quantize(qt[i == 0 ? 0 : 1]);
  }

  std::vector<uint8_t> o;
  o.reserve(1024 + n);
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I',
                          'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00,
                          0x01, 0x00, 0x00};
  o.insert(o.end(), head, head + sizeof(head));
  for (int t = 0; t < (color ? 2 : 1); ++t) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) {
      o.push_back(static_cast<uint8_t>(qt[t][kZigzag[k]]));
    }
  }
  const int nc = color ? 3 : 1;
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * nc);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back(static_cast<uint8_t>(nc));
  for (int i = 0; i < nc; ++i) {
    o.push_back(static_cast<uint8_t>(i + 1));
    o.push_back(color && i == 0 ? 0x22 : 0x11);
    o.push_back(i == 0 ? 0 : 1);
  }
  put_dht(o, 0x00, kDcLumaBits, kDcVals);
  put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  if (color) {
    put_dht(o, 0x01, kDcChromaBits, kDcVals);
    put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * nc);
  o.push_back(static_cast<uint8_t>(nc));
  for (int i = 0; i < nc; ++i) {
    o.push_back(static_cast<uint8_t>(i + 1));
    o.push_back(i == 0 ? 0x00 : 0x11);
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  auto block = [&](int ci, int bx, int by) {
    const EncPlane& p = planes[ci];
    return p.coef.data() + (static_cast<size_t>(by) * p.bw + bx) * 64;
  };
  for (int my = 0; my < mcu_h; ++my) {
    for (int mx = 0; mx < mcu_w; ++mx) {
      if (!color) {
        encode_block(bw, block(0, mx, my), last_dc[0], kDcLuma, kAcLuma);
        continue;
      }
      // 2x2 luma blocks; those past the image's blocks are dummies: zero,
      // with the DC of the block encoded before them (jccoefct.c)
      const EncPlane& yp = planes[0];
      int16_t prev_dc = 0;
      for (int yy = 0; yy < 2; ++yy) {
        for (int xx = 0; xx < 2; ++xx) {
          const int bx = 2 * mx + xx, by = 2 * my + yy;
          int16_t dummy[64] = {};
          const int16_t* blk;
          if (by < yp.bh && bx < yp.bw) {
            blk = block(0, bx, by);
          } else {
            dummy[0] = prev_dc;
            blk = dummy;
          }
          prev_dc = blk[0];
          encode_block(bw, blk, last_dc[0], kDcLuma, kAcLuma);
        }
      }
      encode_block(bw, block(1, mx, my), last_dc[1], kDcChroma, kAcChroma);
      encode_block(bw, block(2, mx, my), last_dc[2], kDcChroma, kAcChroma);
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

template <typename F>
int guarded(char* err, int errlen, F&& f) {
  try {
    f();
    return 0;
  } catch (const Fail& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return -1;
}

}  // namespace

extern "C" {

// Stored size and EXIF orientation (1-8) of a JPEG. Returns 0, or -1 with
// the reason in `err`.
int lh_jpeg_header(const uint8_t* data, int64_t n, int* h, int* w,
                   int* orientation, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Jpeg j;
    j.data = data;
    j.n = static_cast<size_t>(n);
    j.parse(true);
    *h = j.height;
    *w = j.width;
    *orientation = j.orientation;
  });
}

// The orientation tag of an EXIF TIFF structure (a PNG's eXIf chunk).
int lh_tiff_orientation(const uint8_t* data, int64_t n) {
  return tiff_orientation(data, static_cast<size_t>(n));
}

// Decode a baseline JPEG, as stored, into `out` (h x w x 3 RGB, or h x w
// with `gray`).
int lh_jpeg_decode(const uint8_t* data, int64_t n, int gray, uint8_t* out,
                   int h, int w, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    jpeg_decode(data, static_cast<size_t>(n), gray, out, h, w);
  });
}

// Undo the PNG filters of the inflated image data in place and write RGB
// (or gray) pixels to `out`.
int lh_png_decode(uint8_t* raw, int64_t n, int w, int h, int depth,
                  int color_type, const uint8_t* palette, int npal, int gray,
                  uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    png_unfilter(raw, static_cast<size_t>(n), w, h, depth, color_type);
    png_convert(raw, w, h, depth, color_type, palette, npal, gray, out);
  });
}

// Encode h x w gray (c = 1) or h x w x 3 RGB (c = 3) pixels as a
// baseline JPEG at `quality` (0-100) into `out`, which holds `cap` bytes;
// *out_len is the length written. Returns 0, or -1 with the reason in
// `err`.
int lh_jpeg_encode(const uint8_t* img, int h, int w, int c, int quality,
                   uint8_t* out, int64_t cap, int64_t* out_len, char* err,
                   int errlen) {
  return guarded(err, errlen, [&] {
    const std::vector<uint8_t> o = jpeg_encode(img, h, w, c, quality);
    if (static_cast<int64_t>(o.size()) > cap) {
      fail("jpeg_encode: output buffer too small");
    }
    std::memcpy(out, o.data(), o.size());
    *out_len = static_cast<int64_t>(o.size());
  });
}

void lh_resize_linear(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                      int H, int W) {
  resize_linear(src, h, w, c, dst, H, W);
}

void lh_warp_affine_inverse(const uint8_t* src, int h, int w, int c,
                            const double* m, uint8_t* dst, int H, int W) {
  warp_affine_inverse(src, h, w, c, m, dst, H, W);
}

}  // extern "C"
