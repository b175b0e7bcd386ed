// Fast Radiance RGBE scanline codec (new-style per-component RLE).
//
// Native fast path behind ptx_torch.io.read_hdr / write_hdr — same wire
// format as the Python codec (the reference's format: image.cpp:212-324
// decode, :398-481 encode; both re-derived, not translated).  Operates on raw
// scanline bytes; float<->RGBE conversion stays in numpy (vectorized).

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool read(void* dst, size_t k) {
    if (pos + k > n) return false;
    std::memcpy(dst, p + pos, k);
    pos += k;
    return true;
  }
};

}  // namespace

extern "C" {

// Decode the scanline section of an HDR file (after the header) into
// interleaved RGBE bytes (h*w*4).  Returns 0 on success, negative error.
int ptx_rgbe_decode(const uint8_t* data, size_t len, int w, int h,
                    uint8_t* out) {
  Reader r{data, len};
  for (int y = 0; y < h; ++y) {
    uint8_t intro[4];
    if (!r.read(intro, 4)) return -1;
    uint8_t* row = out + static_cast<size_t>(y) * w * 4;
    if (intro[0] == 2 && intro[1] == 2 && !(intro[2] & 0x80)) {
      if (((intro[2] << 8) | intro[3]) != w) return -2;
      for (int c = 0; c < 4; ++c) {
        int x = 0;
        while (x < w) {
          uint8_t code;
          if (!r.read(&code, 1)) return -1;
          if (code > 0x80) {  // run
            int count = code - 0x80;
            uint8_t v;
            if (!r.read(&v, 1)) return -1;
            if (x + count > w) return -3;
            for (int i = 0; i < count; ++i) row[(x++) * 4 + c] = v;
          } else {  // literal
            int count = code;
            if (x + count > w) return -3;
            for (int i = 0; i < count; ++i) {
              uint8_t v;
              if (!r.read(&v, 1)) return -1;
              row[(x++) * 4 + c] = v;
            }
          }
        }
      }
    } else {
      // old-style packed records; (1,1,1,n) repeats previous pixel with
      // escalating shift (implemented correctly, unlike the reference's
      // dead legacy branch, image.cpp:268-303)
      int x = 0, rshift = 0;
      uint8_t rec[4];
      std::memcpy(rec, intro, 4);
      for (;;) {
        if (rec[0] == 1 && rec[1] == 1 && rec[2] == 1) {
          if (rshift >= 32) return -4;
          long count = static_cast<long>(rec[3]) << rshift;
          if (count == 0 || x == 0 || x + count > w) return -4;
          for (long i = 0; i < count; ++i) {
            std::memcpy(row + x * 4, row + (x - 1) * 4, 4);
            ++x;
          }
          rshift += 8;
        } else {
          std::memcpy(row + x * 4, rec, 4);
          ++x;
          rshift = 0;
        }
        if (x >= w) break;
        if (!r.read(rec, 4)) return -1;
      }
    }
  }
  return 0;
}

// Encode interleaved RGBE bytes (h*w*4) as new-style RLE scanlines.
// Writes at most cap bytes; stores the total in *out_len (call with
// out==nullptr/cap==0 to size).  Returns 0 ok, -1 if cap too small.
int ptx_rgbe_encode(const uint8_t* rgbe, int w, int h, uint8_t* out,
                    size_t cap, size_t* out_len) {
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(h) * w * 4 / 2);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rgbe + static_cast<size_t>(y) * w * 4;
    buf.push_back(2);
    buf.push_back(2);
    buf.push_back((w >> 8) & 0xFF);
    buf.push_back(w & 0xFF);
    for (int c = 0; c < 4; ++c) {
      int x = 0;
      while (x < w) {
        // find next run of >=3 equal bytes
        int run_start = x, run_len = 0;
        while (run_start < w) {
          run_len = 1;
          while (run_start + run_len < w && run_len < 0x7F &&
                 row[(run_start + run_len) * 4 + c] == row[run_start * 4 + c])
            ++run_len;
          if (run_len >= 3) break;
          run_start += run_len;
        }
        if (run_start >= w) run_len = 0;
        int lit = run_start - x;
        while (lit > 0) {
          int nb = lit < 0x80 ? lit : 0x80;
          buf.push_back(static_cast<uint8_t>(nb));
          for (int i = 0; i < nb; ++i) buf.push_back(row[(x + i) * 4 + c]);
          x += nb;
          lit -= nb;
        }
        if (run_len >= 3) {
          buf.push_back(static_cast<uint8_t>(0x80 + run_len));
          buf.push_back(row[run_start * 4 + c]);
          x = run_start + run_len;
        }
      }
    }
  }
  *out_len = buf.size();
  if (out == nullptr || cap < buf.size()) return out ? -1 : 0;
  std::memcpy(out, buf.data(), buf.size());
  return 0;
}

}  // extern "C"
