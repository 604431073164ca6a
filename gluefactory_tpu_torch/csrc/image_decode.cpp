// Host-side image decoding: baseline JPEG as libjpeg-turbo 3.1 decodes it
// (the library OpenCV 5 bundles, so `cv2.imread` and this code give the same
// bytes), and PNG scanline unfiltering.
//
// Replaces no TPU kernel: the JAX package reads images with cv2 on the host.
// It runs on the CPU, in the data loaders' threads, with no CUDA. The
// container parsing (markers, chunks, zlib) is Python in
// datasets/image_codecs.py; this file does the loops that are serial per
// bit or per row and would cost seconds an image in Python:
//   gf_jpeg_scan      Huffman decoding of one scan into the coefficient
//                     buffers (jdhuff.c), DC prediction reset at each
//                     restart marker;
//   gf_jpeg_idct      dequantisation and the `islow` integer IDCT
//                     (jidctint.c: CONST_BITS 13, PASS1_BITS 2, the range
//                     limit table of jdmaster.c);
//   gf_jpeg_upsample  one component to the full image size: jdsample.c's
//                     fancy (triangle) upsampling for h2v1, h1v2 and h2v2,
//                     box replication for other integral factors or where
//                     libjpeg turns fancy off (a downsampled width <= 2),
//                     the edge rows and columns replicated as jdmainct.c's
//                     context pointers and jdsample.c's loops do;
//   gf_jpeg_ycc_rgb   YCbCr to RGB through jdcolor.c's fixed-point tables;
//   gf_png_unfilter   PNG filters 0-4 (None, Sub, Up, Average, Paeth).
// The SIMD paths of libjpeg-turbo give the same bytes as its C code for the
// islow IDCT, fancy upsampling and colour conversion, which is what this
// follows. Every function returns 0, or a negative code on malformed input.
#include <cstdint>
#include <cstring>

namespace {

// zigzag index -> natural index, with 16 extra entries (libjpeg's
// jpeg_natural_order) so that a corrupt run cannot write out of the block
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// A Huffman table as jdhuff.c derives it: maxcode / valoffset per code
// length and a lookahead table of the first 9 bits.
struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  int16_t look_len[512];  // code length for 9-bit prefixes, 0 if longer
  uint8_t look_sym[512];
  bool present;
};

int build_huff(const uint8_t* spec, Huff* h) {
  // spec: 16 counts, then up to 256 symbols
  const uint8_t* counts = spec;
  int total = 0;
  for (int l = 0; l < 16; ++l) total += counts[l];
  if (total > 256) return -10;
  std::memcpy(h->vals, spec + 16, 256);
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) return -11;  // bad table
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      h->valoffset[l] = p - huffcode[p];
      p += counts[l - 1];
      h->maxcode[l] = huffcode[p - 1];
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->valoffset[17] = 0;
  h->maxcode[17] = 0x7FFFFFFF;  // ensures the slow loop ends
  std::memset(h->look_len, 0, sizeof(h->look_len));
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 1; i <= counts[l - 1]; ++i, ++p) {
      int prefix = huffcode[p] << (9 - l);
      for (int c = 0; c < (1 << (9 - l)); ++c) {
        h->look_len[prefix + c] = (int16_t)l;
        h->look_sym[prefix + c] = h->vals[p];
      }
    }
  }
  h->present = true;
  return 0;
}

// The entropy-coded bytes with libjpeg's stuffing rules: FF 00 is an FF data
// byte, FF FF ... pads a marker, and a marker ends the data (zeros follow).
struct Bits {
  const uint8_t* data;
  int64_t size;
  int64_t pos;         // next byte to read
  int64_t marker_pos;  // offset of the FF of the marker hit, -1 if none
  uint64_t buf;        // bits from the top
  int nbits;
  int real_bits;       // of nbits, those from data bytes (the rest are zeros)
  bool overrun;        // a code read past the marker or the end of the data

  void fill() {
    while (nbits <= 56) {
      uint32_t c = 0;
      bool real = false;
      if (marker_pos < 0 && pos < size) {
        c = data[pos];
        if (c == 0xFF) {
          int64_t q = pos + 1;
          while (q < size && data[q] == 0xFF) ++q;
          if (q < size && data[q] == 0) {
            pos = q + 1;
            real = true;
          } else {
            marker_pos = q < size ? q - 1 : pos;
            c = 0;
          }
        } else {
          ++pos;
          real = true;
        }
      }
      buf |= (uint64_t)c << (56 - nbits);
      nbits += 8;
      if (real) real_bits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return (uint32_t)(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    nbits -= n;
    if (n > real_bits) overrun = true;
    real_bits = n > real_bits ? 0 : real_bits - n;
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  void reset() {
    buf = 0;
    nbits = 0;
    real_bits = 0;
  }
};

inline int huff_extend(int x, int s) {
  return x < (1 << (s - 1)) ? x + (int)((~0u) << s) + 1 : x;
}

inline int decode_sym(Bits& b, const Huff& h) {
  uint32_t look = b.peek(9);
  int l = h.look_len[look];
  if (l) {
    b.skip(l);
    return h.look_sym[look];
  }
  // longer code: jdhuff.c's jpeg_huff_decode
  int32_t code = (int32_t)b.get(10);
  l = 10;
  while (l <= 16 && code > h.maxcode[l]) {
    code = (code << 1) | (int32_t)b.get(1);
    ++l;
  }
  if (l > 16) return -1;
  return h.vals[(code + h.valoffset[l]) & 0xFF];
}

// 1024-entry post-IDCT range limit of jdmaster.c: index = value & 1023,
// value centred on 0; [0, 128) -> +128, [128, 512) -> 255, [512, 896) -> 0,
// [896, 1024) -> value - 896 (the negatives down to -128, +128).
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x)
      t[x] = x < 128 ? (uint8_t)(x + 128) : x < 512 ? 255 : x < 896 ? 0 : (uint8_t)(x - 896);
  }
};
const RangeLimit kRange;

inline int descale(int64_t x, int n) { return (int)((x + ((int64_t)1 << (n - 1))) >> n); }

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

// jidctint.c jpeg_idct_islow on one block: coef in natural order, quant in
// natural order, out rows of `stride` bytes.
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int32_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int32_t dc = ((int32_t)in[0] * q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int32_t)in[16] * q[16], z3 = (int32_t)in[48] * q[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = (int32_t)in[0] * q[0];
    z3 = (int32_t)in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int32_t)in[56] * q[56];
    tmp1 = (int32_t)in[40] * q[40];
    tmp2 = (int32_t)in[24] * q[24];
    tmp3 = (int32_t)in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + (int64_t)r * stride;
    const int n = kConstBits + kPass1Bits + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.t[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
    o[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
    o[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
    o[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
    o[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
    o[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
    o[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
    o[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
  }
}

// jdcolor.c's tables (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = 1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

}  // namespace

extern "C" {

// Decode one scan. comp: per component of the scan, 7 ints
//   [h, v, stride_blocks, blocks_w, blocks_h, dc_table, ac_table]
// (blocks_w / blocks_h: the blocks a one-component scan covers; the MCU grid
// otherwise), coefs: per component an int16 buffer of (rows, stride_blocks,
// 64) in natural order, huff: 8 tables (4 DC then 4 AC) of 16 counts and 256
// symbols, present: their flags. `*end` receives the offset of the marker
// that follows the scan. Returns 0, or -1 bad code, -2 missing table, -3 a
// missing or wrong restart marker, -4 data ended inside the scan, -7 a scan
// of other than 1 to 4 components or a table id above 3.
int gf_jpeg_scan(const uint8_t* data, int64_t size, int ncomp, const int32_t* comp,
                 int16_t* const* coefs, const uint8_t* huff, const uint8_t* present,
                 int mcus_x, int mcus_y, int restart_interval, int64_t* end) {
  if (ncomp < 1 || ncomp > 4) return -7;  // jdmarker.c: MAX_COMPS_IN_SCAN
  for (int c = 0; c < ncomp; ++c) {
    if (comp[7 * c + 5] < 0 || comp[7 * c + 5] > 3 || comp[7 * c + 6] < 0 || comp[7 * c + 6] > 3)
      return -7;
  }
  static thread_local Huff tables[8];
  for (int t = 0; t < 8; ++t) {
    tables[t].present = false;
    if (present[t]) {
      int rc = build_huff(huff + t * 272, &tables[t]);
      if (rc) return rc;
    }
  }
  for (int c = 0; c < ncomp; ++c) {
    if (!tables[comp[7 * c + 5]].present || !tables[4 + comp[7 * c + 6]].present) return -2;
  }
  Bits b{data, size, 0, -1, 0, 0, 0, false};
  int dc_pred[4] = {0, 0, 0, 0};
  const bool single = ncomp == 1;
  const int64_t n_mcu = single ? (int64_t)comp[3] * comp[4] : (int64_t)mcus_x * mcus_y;
  const int per_row = single ? comp[3] : mcus_x;
  int next_rst = 0;
  int64_t until_restart = restart_interval;

  auto decode_block = [&](int c, int16_t* blk) -> int {
    const Huff& dc = tables[comp[7 * c + 5]];
    const Huff& ac = tables[4 + comp[7 * c + 6]];
    int s = decode_sym(b, dc);
    if (s < 0 || s > 15) return -1;
    int diff = s ? huff_extend((int)b.get(s), s) : 0;
    dc_pred[c] += diff;
    blk[0] = (int16_t)dc_pred[c];
    for (int k = 1; k < 64; ++k) {
      int rs = decode_sym(b, ac);
      if (rs < 0) return -1;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)huff_extend((int)b.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return 0;
  };

  for (int64_t m = 0; m < n_mcu; ++m) {
    if (restart_interval) {
      if (until_restart == 0) {
        // jdhuff.c process_restart: drop the buffered bits, read RSTn
        b.reset();
        int64_t q = b.marker_pos >= 0 ? b.marker_pos : b.pos;
        while (q + 1 < size && !(data[q] == 0xFF && data[q + 1] != 0 && data[q + 1] != 0xFF))
          ++q;
        if (q + 1 >= size || data[q + 1] != 0xD0 + next_rst) return -3;
        b.pos = q + 2;
        b.marker_pos = -1;
        next_rst = (next_rst + 1) & 7;
        for (int c = 0; c < 4; ++c) dc_pred[c] = 0;
        until_restart = restart_interval;
      }
      --until_restart;
    }
    const int mx = (int)(m % per_row), my = (int)(m / per_row);
    for (int c = 0; c < ncomp; ++c) {
      const int* ci = comp + 7 * c;
      const int h = single ? 1 : ci[0], v = single ? 1 : ci[1], stride = ci[2];
      for (int by = 0; by < v; ++by)
        for (int bx = 0; bx < h; ++bx) {
          int64_t row = (int64_t)my * v + by, col = (int64_t)mx * h + bx;
          int16_t* blk = coefs[c] + (row * stride + col) * 64;
          int rc = decode_block(c, blk);
          if (rc) return rc;
        }
    }
  }
  if (b.overrun) return -4;
  int64_t q = b.marker_pos >= 0 ? b.marker_pos : b.pos;
  while (q + 1 < size && !(data[q] == 0xFF && data[q + 1] != 0 && data[q + 1] != 0xFF)) ++q;
  *end = q;
  return 0;
}

// Dequantise and inverse-transform a component: coef (bh, bw, 64) natural
// order, quant 64 values in natural order, out (bh * 8, bw * 8).
int gf_jpeg_idct(const int16_t* coef, int bw, int bh, const uint16_t* quant, uint8_t* out) {
  const int stride = bw * 8;
  for (int by = 0; by < bh; ++by)
    for (int bx = 0; bx < bw; ++bx)
      idct_islow(coef + ((int64_t)by * bw + bx) * 64, quant,
                 out + (int64_t)by * 8 * stride + bx * 8, stride);
  return 0;
}

// One component (dw x dh samples of a plane of row stride `stride`) to
// (height, width) at integral factors (fh, fv), as jdsample.c does with
// do_fancy_upsampling on.
int gf_jpeg_upsample(const uint8_t* in, int stride, int dw, int dh, int fh, int fv,
                     uint8_t* out, int width, int height) {
  if (dw < 1 || dh < 1 || fh < 1 || fv < 1) return -5;
  auto row = [&](int y) { return in + (int64_t)clampi(y, 0, dh - 1) * stride; };
  if (fh == 1 && fv == 1) {
    for (int y = 0; y < height; ++y) std::memcpy(out + (int64_t)y * width, row(y), width);
    return 0;
  }
  if (fh == 2 && fv == 1 && dw > 2) {  // h2v1_fancy_upsample
    uint8_t* tmp = new uint8_t[(size_t)dw * 2];
    for (int y = 0; y < height; ++y) {
      const uint8_t* p = row(y);
      uint8_t* o = tmp;
      int v = p[0];
      *o++ = (uint8_t)v;
      *o++ = (uint8_t)((v * 3 + p[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        v = p[x] * 3;
        *o++ = (uint8_t)((v + p[x - 1] + 1) >> 2);
        *o++ = (uint8_t)((v + p[x + 1] + 2) >> 2);
      }
      v = p[dw - 1];
      *o++ = (uint8_t)((v * 3 + p[dw - 2] + 1) >> 2);
      *o++ = (uint8_t)v;
      std::memcpy(out + (int64_t)y * width, tmp, width);
    }
    delete[] tmp;
    return 0;
  }
  if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; ++y) {
      int iy = y >> 1;
      const uint8_t* p0 = row(iy);
      const uint8_t* p1 = row((y & 1) ? iy + 1 : iy - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = out + (int64_t)y * width;
      for (int x = 0; x < width; ++x) o[x] = (uint8_t)((p0[x] * 3 + p1[x] + bias) >> 2);
    }
    return 0;
  }
  if (fh == 2 && fv == 2 && dw > 2) {  // h2v2_fancy_upsample
    uint8_t* tmp = new uint8_t[(size_t)dw * 2];
    for (int y = 0; y < height; ++y) {
      int iy = y >> 1;
      const uint8_t* p0 = row(iy);
      const uint8_t* p1 = row((y & 1) ? iy + 1 : iy - 1);
      uint8_t* o = tmp;
      int this_sum = p0[0] * 3 + p1[0];
      int next_sum = p0[1] * 3 + p1[1];
      *o++ = (uint8_t)((this_sum * 4 + 8) >> 4);
      *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 2; x < dw; ++x) {
        next_sum = p0[x] * 3 + p1[x];
        *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = (uint8_t)((this_sum * 4 + 7) >> 4);
      std::memcpy(out + (int64_t)y * width, tmp, width);
    }
    delete[] tmp;
    return 0;
  }
  // box replication (h2v1 / h2v2 with dw <= 2, int_upsample otherwise)
  for (int y = 0; y < height; ++y) {
    const uint8_t* p = row(y / fv);
    uint8_t* o = out + (int64_t)y * width;
    for (int x = 0; x < width; ++x) o[x] = p[x / fh];
  }
  return 0;
}

// (n) Y, Cb, Cr samples to n RGB triplets.
int gf_jpeg_ycc_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int64_t n,
                    uint8_t* rgb) {
  for (int64_t i = 0; i < n; ++i) {
    int Y = y[i], b = cb[i], r = cr[i];
    rgb[3 * i + 0] = clamp255(Y + kYcc.cr_r[r]);
    rgb[3 * i + 1] = clamp255(Y + (int)((kYcc.cb_g[b] + kYcc.cr_g[r]) >> 16));
    rgb[3 * i + 2] = clamp255(Y + kYcc.cb_b[b]);
  }
  return 0;
}

// Undo the PNG filters in place of `out`: data holds `height` rows of one
// filter byte and `row_bytes` bytes; bpp the bytes a pixel (at least 1).
int gf_png_unfilter(const uint8_t* data, int height, int64_t row_bytes, int bpp,
                    uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = data + (int64_t)y * (row_bytes + 1);
    uint8_t* o = out + (int64_t)y * row_bytes;
    const int f = in[0];
    ++in;
    switch (f) {
      case 0:
        std::memcpy(o, in, row_bytes);
        break;
      case 1:
        for (int64_t x = 0; x < row_bytes; ++x)
          o[x] = (uint8_t)(in[x] + (x >= bpp ? o[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < row_bytes; ++x) o[x] = (uint8_t)(in[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? o[x - bpp] : 0, up = prev ? prev[x] : 0;
          o[x] = (uint8_t)(in[x] + ((a + up) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? o[x - bpp] : 0, up = prev ? prev[x] : 0;
          int c = (x >= bpp && prev) ? prev[x - bpp] : 0;
          int p = a + up - c, pa = p > a ? p - a : a - p, pb = p > up ? p - up : up - p,
              pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? up : c);
          o[x] = (uint8_t)(in[x] + pred);
        }
        break;
      default:
        return -6;
    }
    prev = o;
  }
  return 0;
}

}  // extern "C"
