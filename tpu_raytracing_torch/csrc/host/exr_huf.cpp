// OpenEXR PIZ Huffman decoder (hot path of PIZ EXR reads).
//
// Semantics follow the OpenEXR 2.x file-format specification for the
// Huffman-coded section of PIZ-compressed blocks (the format the
// reference reads through the Rust `exr` crate,
// crates/raytracing-cpu/src/utils.rs:50-131): a 20-byte header
// (im, iM, tableLength, nBits), a 6-bit-packed canonical code-length
// table with zero-run escapes, then an MSB-first bitstream with a
// run-length pseudo-symbol at index iM. The port's copy of the JAX
// package's csrc/exr_huf.cpp, unchanged below this header. Exposed via
// ctypes (tpu_raytracing_torch/native.py); the pure-Python decode with
// identical behavior lives in tpu_raytracing_torch/utils/exr_piz.py.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int HUF_ENCSIZE = (1 << 16) + 1;
constexpr int HUF_DECBITS = 14;
constexpr int HUF_DECSIZE = 1 << HUF_DECBITS;
constexpr uint64_t HUF_DECMASK = HUF_DECSIZE - 1;

constexpr int SHORT_ZEROCODE_RUN = 59;
constexpr int LONG_ZEROCODE_RUN = 63;
constexpr int SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN;

struct HufDec {
  int len = 0;              // short code: code length; 0 = long/invalid
  int lit = 0;              // short code: symbol; long code: #candidates
  std::vector<int> p;       // long code: candidate symbols
};

inline uint64_t huf_code(uint64_t h) { return h >> 6; }
inline int huf_length(uint64_t h) { return int(h & 63); }

struct BitReader {
  const uint8_t* in;
  const uint8_t* end;
  uint64_t c = 0;
  int lc = 0;
  bool ok = true;

  int get_bits(int n) {
    while (lc < n) {
      if (in >= end) { ok = false; return 0; }
      c = (c << 8) | uint64_t(*in++);
      lc += 8;
    }
    lc -= n;
    return int((c >> lc) & ((uint64_t(1) << n) - 1));
  }
};

// Unpack the 6-bit-packed code-length table, then assign canonical codes.
bool unpack_enc_table(const uint8_t*& ptr, const uint8_t* end, int im, int iM,
                      std::vector<uint64_t>& hcode) {
  hcode.assign(HUF_ENCSIZE, 0);
  BitReader br{ptr, end};
  for (; im <= iM; im++) {
    int l = br.get_bits(6);
    if (!br.ok) return false;
    hcode[im] = uint64_t(l);
    if (l == LONG_ZEROCODE_RUN) {
      int zerun = br.get_bits(8) + SHORTEST_LONG_RUN;
      if (!br.ok || im + zerun > iM + 1) return false;
      while (zerun--) hcode[im++] = 0;
      im--;
    } else if (l >= SHORT_ZEROCODE_RUN) {
      int zerun = l - SHORT_ZEROCODE_RUN + 2;
      if (im + zerun > iM + 1) return false;
      while (zerun--) hcode[im++] = 0;
      im--;
    }
  }
  ptr = br.in;

  // Canonical code assignment (codes of equal length are consecutive,
  // ordered by symbol; lengths capped at 58).
  uint64_t n[59] = {0};
  for (int i = 0; i < HUF_ENCSIZE; i++) {
    uint64_t l = hcode[i];
    if (l > 58) return false;
    n[l] += 1;
  }
  uint64_t c = 0;
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (int i = 0; i < HUF_ENCSIZE; i++) {
    int l = int(hcode[i]);
    if (l > 0) hcode[i] = uint64_t(l) | (n[l]++ << 6);
  }
  return true;
}

bool build_dec_table(const std::vector<uint64_t>& hcode, int im, int iM,
                     std::vector<HufDec>& hdecod) {
  hdecod.assign(HUF_DECSIZE, HufDec{});
  for (; im <= iM; im++) {
    uint64_t c = huf_code(hcode[im]);
    int l = huf_length(hcode[im]);
    if (c >> l) return false;
    if (l > HUF_DECBITS) {
      HufDec& pl = hdecod[size_t(c >> (l - HUF_DECBITS))];
      if (pl.len) return false;
      pl.lit++;
      pl.p.push_back(im);
    } else if (l) {
      size_t base = size_t(c << (HUF_DECBITS - l));
      size_t span = size_t(1) << (HUF_DECBITS - l);
      for (size_t i = 0; i < span; i++) {
        HufDec& pl = hdecod[base + i];
        if (pl.len || !pl.p.empty()) return false;
        pl.len = l;
        pl.lit = im;
      }
    }
  }
  return true;
}

struct Decoder {
  const std::vector<uint64_t>& hcode;
  const std::vector<HufDec>& hdecod;
  uint16_t* out;
  uint16_t* const out_start;
  uint16_t* const out_end;
  int rlc;

  // Emit a decoded symbol; rlc triggers a run of the previous value.
  bool emit(int po, uint64_t& c, int& lc, const uint8_t*& in,
            const uint8_t* ie) {
    if (po == rlc) {
      if (lc < 8) {
        if (in >= ie) return false;
        c = (c << 8) | uint64_t(*in++);
        lc += 8;
      }
      lc -= 8;
      int cs = int((c >> lc) & 0xff);
      if (out + cs > out_end || out == out_start) return false;
      uint16_t s = out[-1];
      while (cs-- > 0) *out++ = s;
    } else if (out < out_end) {
      *out++ = uint16_t(po);
    } else {
      return false;
    }
    return true;
  }
};

bool huf_decode(const std::vector<uint64_t>& hcode,
                const std::vector<HufDec>& hdecod, const uint8_t* in,
                int64_t ni_bits, int rlc, uint16_t* out, int64_t n_out) {
  uint64_t c = 0;
  int lc = 0;
  const uint8_t* ie = in + (ni_bits + 7) / 8;
  Decoder d{hcode, hdecod, out, out, out + n_out, rlc};

  while (in < ie) {
    c = (c << 8) | uint64_t(*in++);
    lc += 8;
    while (lc >= HUF_DECBITS) {
      const HufDec& pl = hdecod[size_t((c >> (lc - HUF_DECBITS)) & HUF_DECMASK)];
      if (pl.len) {
        lc -= pl.len;
        if (!d.emit(pl.lit, c, lc, in, ie)) return false;
      } else {
        if (pl.p.empty()) return false;
        size_t j = 0;
        for (; j < pl.p.size(); j++) {
          int l = huf_length(hcode[pl.p[j]]);
          while (lc < l && in < ie) {
            c = (c << 8) | uint64_t(*in++);
            lc += 8;
          }
          if (lc >= l &&
              huf_code(hcode[pl.p[j]]) ==
                  ((c >> (lc - l)) & ((uint64_t(1) << l) - 1))) {
            lc -= l;
            if (!d.emit(pl.p[j], c, lc, in, ie)) return false;
            break;
          }
        }
        if (j == pl.p.size()) return false;
      }
    }
  }

  // Flush: the last byte may be partial (ni_bits not a multiple of 8).
  int i = int((8 - ni_bits) & 7);
  c >>= i;
  lc -= i;
  while (lc > 0) {
    const HufDec& pl = hdecod[size_t((c << (HUF_DECBITS - lc)) & HUF_DECMASK)];
    if (!pl.len) return false;
    lc -= pl.len;
    if (!d.emit(pl.lit, c, lc, in, ie)) return false;
  }
  return d.out == d.out_end;
}

inline uint32_t read_u32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

}  // namespace

extern "C" {

// Returns 0 on success, <0 on malformed input.
int tpu_rt_huf_uncompress(const uint8_t* compressed, int64_t n_compressed,
                          uint16_t* raw, int64_t n_raw) {
  if (n_compressed == 0) return n_raw == 0 ? 0 : -1;
  if (n_compressed < 20) return -2;
  int64_t im = read_u32(compressed);
  int64_t iM = read_u32(compressed + 4);
  int64_t n_bits = read_u32(compressed + 12);
  if (im < 0 || im >= HUF_ENCSIZE || iM < 0 || iM >= HUF_ENCSIZE) return -3;
  const uint8_t* ptr = compressed + 20;
  const uint8_t* end = compressed + n_compressed;

  std::vector<uint64_t> hcode;
  if (!unpack_enc_table(ptr, end, int(im), int(iM), hcode)) return -4;
  if (n_bits > 8 * (end - ptr)) return -5;

  std::vector<HufDec> hdecod;
  if (!build_dec_table(hcode, int(im), int(iM), hdecod)) return -6;
  if (!huf_decode(hcode, hdecod, ptr, n_bits, int(iM), raw, n_raw)) return -7;
  return 0;
}

}  // extern "C"
