// COCO-style run-length-encoded mask codec (native, host side).
//
// A copy of editanything_tpu/ops/rle.cc, built by the port with the host's
// C++ compiler at first use (editanything_tpu_torch/ops/rle.py).
//
// Replaces pycocotools' C backend (`maskUtils.decode`, consumed by the
// reference's training dataset at utils/sam_dataset.py:44 to
// decode SA-1B annotations) — pycocotools is no dependency of the port and
// the decode is on the data-loader hot path (thousands of masks per batch).
//
// Format (identical to pycocotools):
//   - counts string: base-64-ish chars ('0'+6-bit groups), little-endian
//     5-bit payloads with bit 0x20 as "more" flag, sign-extended via 0x10;
//     every count after the first two is delta-coded against count[i-2].
//   - runs alternate background/foreground in COLUMN-MAJOR (Fortran) order.
//
// rle_id_map paints N masks into one uint16 ID map in a single pass (later
// masks overwrite earlier) — the reference materializes every mask as a
// full H*W array and loops in Python (sam_dataset.py:34-52); here the
// condition map costs O(total runs), not O(N*H*W).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Decode the counts string into run lengths. Returns number of runs.
int from_string(const char* s, std::vector<int64_t>& cnts) {
  cnts.clear();
  size_t m = 0;
  while (s[m]) {
    int64_t x = 0;
    int k = 0;
    int more = 1;
    while (more) {
      int64_t c = s[m] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (int)(c & 0x20);
      m++;
      k++;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
      if (!s[m - 1]) return -1;  // truncated
    }
    if (cnts.size() > 2) x += cnts[cnts.size() - 2];
    cnts.push_back(x);
  }
  return (int)cnts.size();
}

}  // namespace

extern "C" {

// Decode one RLE into `out` (h*w bytes, ROW-major). Returns 0 on success.
int rle_decode(const char* s, int64_t h, int64_t w, uint8_t* out) {
  std::vector<int64_t> cnts;
  if (from_string(s, cnts) < 0) return 1;
  // runs are column-major; write transposed into row-major out
  int64_t pos = 0;                 // linear index in column-major space
  uint8_t val = 0;
  const int64_t total = h * w;
  for (size_t i = 0; i < cnts.size(); i++) {
    int64_t run = cnts[i];
    if (run < 0 || pos + run > total) return 2;
    if (val) {
      for (int64_t j = pos; j < pos + run; j++) {
        const int64_t col = j / h, row = j % h;
        out[row * w + col] = 1;
      }
    }
    pos += run;
    val ^= 1;
  }
  return pos == total ? 0 : 3;
}

// Paint n RLE masks (all h*w) into a uint16 ID map (row-major), ids 1..n in
// order, later masks overwriting earlier ones. Returns 0 on success.
int rle_id_map(const char** strs, int64_t n, int64_t h, int64_t w,
               uint16_t* out) {
  std::memset(out, 0, sizeof(uint16_t) * h * w);
  std::vector<int64_t> cnts;
  for (int64_t id = 0; id < n; id++) {
    if (from_string(strs[id], cnts) < 0) return 1;
    int64_t pos = 0;
    uint8_t val = 0;
    const int64_t total = h * w;
    for (size_t i = 0; i < cnts.size(); i++) {
      int64_t run = cnts[i];
      if (run < 0 || pos + run > total) return 2;
      if (val) {
        for (int64_t j = pos; j < pos + run; j++) {
          const int64_t col = j / h, row = j % h;
          out[row * w + col] = (uint16_t)(id + 1);
        }
      }
      pos += run;
      val ^= 1;
    }
    if (pos != total) return 3;
  }
  return 0;
}

// Encode a row-major binary mask into the counts string. `out` must hold at
// least 6*h*w+1 bytes. Returns the string length, or -1 on overflow.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w, char* out,
                   int64_t out_cap) {
  // build column-major runs
  std::vector<int64_t> cnts;
  int64_t run = 0;
  uint8_t prev = 0;
  for (int64_t col = 0; col < w; col++) {
    for (int64_t row = 0; row < h; row++) {
      const uint8_t v = mask[row * w + col] ? 1 : 0;
      if (v == prev) {
        run++;
      } else {
        cnts.push_back(run);
        run = 1;
        prev = v;
      }
    }
  }
  cnts.push_back(run);
  // serialize (pycocotools rleToString)
  int64_t p = 0;
  for (size_t i = 0; i < cnts.size(); i++) {
    int64_t x = cnts[i];
    if (i > 2) x -= cnts[i - 2];
    int more = 1;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      c += 48;
      if (p >= out_cap - 1) return -1;
      out[p++] = (char)c;
    }
  }
  out[p] = 0;
  return p;
}

}  // extern "C"
