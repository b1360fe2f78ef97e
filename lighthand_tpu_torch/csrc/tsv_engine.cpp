// Host helpers of the TSV storage engine (data/tsv.py, data/native.py):
// a copy of the JAX package's native/tsv_engine.cpp, built for the port by
// ops/kernels/_build.py.
//   - lineidx generation: one buffered pass over multi-GB TSV shards
//     (the reference did a Python readline() loop per row,
//     tsv_file.py:14-23)
//   - base64 decode: table-driven, feeding JPEG buffers to the decoder
//     without Python-level byte shuffling (reference: base64.b64decode per
//     sample, image_ops.py:16-23)
//   - bulk row reads: one call fetches a batch's rows
//
// Plain C linkage for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Scan `tsv_path` and write one decimal byte-offset per line to `idx_path`.
// Returns the number of rows, or -1 on error.
int64_t lh_generate_lineidx(const char* tsv_path, const char* idx_path) {
  FILE* in = std::fopen(tsv_path, "rb");
  if (!in) return -1;
  FILE* out = std::fopen(idx_path, "w");
  if (!out) {
    std::fclose(in);
    return -1;
  }

  constexpr size_t kBuf = 1 << 20;
  std::vector<char> buf(kBuf);
  int64_t pos = 0;
  int64_t rows = 0;
  bool at_line_start = true;

  size_t n;
  while ((n = std::fread(buf.data(), 1, kBuf, in)) > 0) {
    for (size_t i = 0; i < n; ++i) {
      if (at_line_start) {
        std::fprintf(out, "%lld\n", static_cast<long long>(pos + i));
        ++rows;
        at_line_start = false;
      }
      if (buf[i] == '\n') at_line_start = true;
    }
    pos += static_cast<int64_t>(n);
  }
  std::fclose(in);
  std::fclose(out);
  return rows;
}

// Decode base64 `in[0..in_len)` into `out` (caller allocates >= 3/4*in_len).
// Returns decoded byte count, or -1 on invalid input.
int64_t lh_b64_decode(const char* in, int64_t in_len, unsigned char* out) {
  static int8_t table[256];
  static bool init = false;
  if (!init) {
    std::memset(table, -1, sizeof(table));
    const char* alphabet =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    for (int i = 0; i < 64; ++i) table[(unsigned char)alphabet[i]] = (int8_t)i;
    init = true;
  }

  int64_t out_len = 0;
  uint32_t acc = 0;
  int bits = 0;
  for (int64_t i = 0; i < in_len; ++i) {
    unsigned char c = (unsigned char)in[i];
    if (c == '=' || c == '\n' || c == '\r') continue;
    int8_t v = table[c];
    if (v < 0) return -1;
    acc = (acc << 6) | (uint32_t)v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out[out_len++] = (unsigned char)((acc >> bits) & 0xFF);
    }
  }
  return out_len;
}

// Bulk row extraction: given a file and (offset, max_len) pairs, copy each
// row's bytes into a caller-provided arena. Saves Python-level seek/read
// pairs when prefetching a whole batch. Rows are '\n'-terminated; the
// terminator is not copied. Returns 0 on success.
int lh_read_rows(const char* tsv_path, const int64_t* offsets, int n_rows,
                 unsigned char* arena, const int64_t* arena_offsets,
                 int64_t* row_lens, int64_t max_row_len) {
  FILE* in = std::fopen(tsv_path, "rb");
  if (!in) return -1;
  std::vector<char> buf(static_cast<size_t>(max_row_len));
  for (int r = 0; r < n_rows; ++r) {
    if (std::fseek(in, static_cast<long>(offsets[r]), SEEK_SET) != 0) {
      std::fclose(in);
      return -1;
    }
    size_t n = std::fread(buf.data(), 1, static_cast<size_t>(max_row_len), in);
    size_t len = 0;
    while (len < n && buf[len] != '\n') ++len;
    std::memcpy(arena + arena_offsets[r], buf.data(), len);
    row_lens[r] = static_cast<int64_t>(len);
  }
  std::fclose(in);
  return 0;
}

}  // extern "C"
