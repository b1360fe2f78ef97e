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

void lh_resize_linear(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                      int H, int W) {
  resize_linear(src, h, w, c, dst, H, W);
}

void lh_warp_affine_inverse(const uint8_t* src, int h, int w, int c,
                            const double* m, uint8_t* dst, int H, int W) {
  warp_affine_inverse(src, h, w, c, m, dst, H, W);
}

}  // extern "C"
