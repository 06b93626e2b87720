// The port's JPEG stage: decode + crop + resize + flip + normalize of a
// batch of JPEGs in one threaded C++ call, over a JPEG decoder of its
// own (no libjpeg).
//
// The stage around the decode is a copy of native/fastjpeg.cpp's: the
// splitmix64 draws seeded per image, the ResNet RandomResizedCrop and
// the eval central crop in original image coordinates, the DCT scale
// (1/2, 1/4, 1/8) kept while the scaled crop stays >= the output size,
// and the bilinear resize from the scaled crop window into normalized
// float32. The numpy mirror in data/imagenet.py reproduces its draws.
//
// The decoder repeats libjpeg-turbo's default decode in integer
// arithmetic, so that its pixels equal libjpeg's (and PIL's):
//   * baseline and extended sequential Huffman (SOF0, SOF1 at 8 bits)
//     and progressive Huffman (SOF2: spectral selection and successive
//     approximation), restart intervals, standard tables where a
//     stream has no DHT (as libjpeg-turbo does for Motion-JPEG);
//   * one component (grey, replicated to RGB) or three (YCbCr, or RGB
//     after an Adobe APP14 transform 0 or 'R','G','B' component ids),
//     any sampling factors whose ratios are integral;
//   * the islow IDCT (jidctint.c) and the reduced 4x4, 2x2 and 1x1
//     IDCTs (jidctred.c) with libjpeg's post-IDCT range-limit table,
//     each component's IDCT size chosen as jdmaster.c chooses it (chroma
//     scaled up by the IDCT where it can be, not by upsampling);
//   * jdsample.c's h2v1, h1v2 and h2v2 fancy upsampling (plain
//     replication at 1/8 scale and for components two samples wide or
//     less), with edge rows and columns replicated;
//   * jdcolor.c's fixed-point YCbCr->RGB tables.
// Corrupt entropy data decodes as libjpeg decodes it (zero bits past a
// marker, the rest of the segment left zero); CMYK/YCCK, arithmetic
// coding, 12-bit and lossless streams fail (ok = 0).
//
// Huffman data cannot be skipped, so every MCU is entropy-decoded (a
// single-scan image stops after the last MCU row the window needs); the
// IDCT and upsampling run only on the blocks that the crop window and
// one context row and column need. The window's pixels equal the full
// decode's.
//
// ABI (the ctypes ABI of native/fastjpeg.cpp, bound by
// tensorflow_examples_torch/native.py):
//   fj_decode_augment_batch : concatenated jpeg bytes -> f32 NHWC batch
//   fj_jpeg_dims            : header-only (h, w) probe
//   pj_decode_rgb           : the whole image, DCT-scaled by 1/denom, as
//                             uint8 RGB (the decoder alone, for tests)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (no -ljpeg).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ------------------------------------------------------------- threading

template <typename Fn>
void parallel_for(int64_t n, int threads, Fn fn) {
  if (threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([=] {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

// ------------------------------------------------------------------ rng
//
// splitmix64, mirrored in Python ints by data/imagenet.py _SplitMix64.
// All uniforms are drawn as (x >> 11) * 2^-53 float64.

struct SplitMix64 {
  uint64_t s;
  explicit SplitMix64(uint64_t seed) : s(seed) {}
  uint64_t next() {
    s += 0x9E3779B97F4A7C15ULL;
    uint64_t z = s;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  double u01() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

// --------------------------------------------------------------- tables

// Raised wherever libjpeg would raise (its ERREXIT); caught per image.
struct BadJpeg {};
[[noreturn]] void bad() { throw BadJpeg{}; }

// Zigzag -> natural order, with 16 extra entries so that a corrupt run
// past coefficient 63 lands on 63 (libjpeg's jpeg_natural_order).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard tables of the JPEG spec, K.3 (libjpeg's jstdhuff.c).
const uint8_t kDcBits[2][17] = {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kAcBits[2][17] = {{0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
     0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
     0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
     0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
     0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
     0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
     0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
     0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
     0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
     0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
     0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
     0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
     0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// libjpeg's post-IDCT range limit: T[x & 1023] for an IDCT output x
// before the +128 level shift (jdmaster.c prepare_range_limit_table).
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x) {
      int v = x < 512 ? x + 128 : x - 1024 + 128;  // x as a signed 10-bit value
      idct[x] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit kRange;

inline uint8_t limit_idct(int64_t x) { return kRange.idct[static_cast<int>(x) & 1023]; }

// jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16).
struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    const int64_t half = int64_t{1} << 15;
    auto fix = [](double v) { return static_cast<int64_t>(v * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------- IDCTs
//
// The arithmetic of libjpeg's jidctint.c (islow, 8x8) and jidctred.c
// (4x4, 2x2, 1x1): CONST_BITS 13, PASS1_BITS 2, DESCALE rounding. The
// shortcuts for all-zero columns and rows give the same values as the
// full computation.

constexpr int kConstBits = 13, kPass1Bits = 2;
inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }
inline int64_t lshift(int64_t x, int n) { return x * (int64_t{1} << n); }

void idct_8x8(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = static_cast<int>(lshift(ip[0] * qp[0], kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = lshift(z2 + z3, kConstBits);
    int64_t tmp1 = lshift(z2 - z3, kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dc = limit_idct(descale(wp[0], kPass1Bits + 3));
      std::memset(op, dc, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = lshift(int64_t{wp[0]} + wp[4], kConstBits);
    int64_t tmp1 = lshift(int64_t{wp[0]} - wp[4], kConstBits);
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
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    op[0] = limit_idct(descale(tmp10 + tmp3, n));
    op[7] = limit_idct(descale(tmp10 - tmp3, n));
    op[1] = limit_idct(descale(tmp11 + tmp2, n));
    op[6] = limit_idct(descale(tmp11 - tmp2, n));
    op[2] = limit_idct(descale(tmp12 + tmp1, n));
    op[5] = limit_idct(descale(tmp12 - tmp1, n));
    op[3] = limit_idct(descale(tmp13 + tmp0, n));
    op[4] = limit_idct(descale(tmp13 - tmp0, n));
  }
}

void idct_4x4(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;  // the second pass does not read column 4
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = static_cast<int>(lshift(ip[0] * qp[0], kPass1Bits));
      for (int r = 0; r < 4; ++r) wp[r * 8] = dc;
      continue;
    }
    int64_t tmp0 = lshift(ip[0] * qp[0], kConstBits + 1);
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t tmp2 = z2 * 15137 + z3 * -6270;
    int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    int64_t z1 = ip[56] * qp[56];
    z2 = ip[40] * qp[40];
    z3 = ip[24] * qp[24];
    int64_t z4 = ip[8] * qp[8];
    tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697;
    tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995;
    const int n = kConstBits - kPass1Bits + 1;
    wp[0] = static_cast<int>(descale(tmp10 + tmp2, n));
    wp[24] = static_cast<int>(descale(tmp10 - tmp2, n));
    wp[8] = static_cast<int>(descale(tmp12 + tmp0, n));
    wp[16] = static_cast<int>(descale(tmp12 - tmp0, n));
  }
  for (int r = 0; r < 4; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dc = limit_idct(descale(wp[0], kPass1Bits + 3));
      std::memset(op, dc, 4);
      continue;
    }
    int64_t tmp0 = lshift(wp[0], kConstBits + 1);
    int64_t tmp2 = int64_t{wp[2]} * 15137 + int64_t{wp[6]} * -6270;
    int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    int64_t z1 = wp[7], z2 = wp[5], z3 = wp[3], z4 = wp[1];
    tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697;
    tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995;
    const int n = kConstBits + kPass1Bits + 3 + 1;
    op[0] = limit_idct(descale(tmp10 + tmp2, n));
    op[3] = limit_idct(descale(tmp10 - tmp2, n));
    op[1] = limit_idct(descale(tmp12 + tmp0, n));
    op[2] = limit_idct(descale(tmp12 - tmp0, n));
  }
}

void idct_2x2(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;  // not read by the second pass
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[24] && !ip[40] && !ip[56]) {
      int dc = static_cast<int>(lshift(ip[0] * qp[0], kPass1Bits));
      wp[0] = wp[8] = dc;
      continue;
    }
    int64_t tmp10 = lshift(ip[0] * qp[0], kConstBits + 2);
    int64_t tmp0 = int64_t{ip[56] * qp[56]} * -5906 + int64_t{ip[40] * qp[40]} * 6967 +
                   int64_t{ip[24] * qp[24]} * -10426 + int64_t{ip[8] * qp[8]} * 29692;
    const int n = kConstBits - kPass1Bits + 2;
    wp[0] = static_cast<int>(descale(tmp10 + tmp0, n));
    wp[8] = static_cast<int>(descale(tmp10 - tmp0, n));
  }
  for (int r = 0; r < 2; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[3] && !wp[5] && !wp[7]) {
      op[0] = op[1] = limit_idct(descale(wp[0], kPass1Bits + 3));
      continue;
    }
    int64_t tmp10 = lshift(wp[0], kConstBits + 2);
    int64_t tmp0 = int64_t{wp[7]} * -5906 + int64_t{wp[5]} * 6967 + int64_t{wp[3]} * -10426 +
                   int64_t{wp[1]} * 29692;
    const int n = kConstBits + kPass1Bits + 3 + 2;
    op[0] = limit_idct(descale(tmp10 + tmp0, n));
    op[1] = limit_idct(descale(tmp10 - tmp0, n));
  }
}

void idct_1x1(const int16_t* in, const uint16_t* q, uint8_t* out, int) {
  out[0] = limit_idct(descale(in[0] * q[0], 3));
}

// ------------------------------------------------------------- Huffman

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

constexpr int kLookBits = 9;

// jdhuff.c's d_derived_tbl, with a 9-bit lookahead.
struct Derived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0 = longer code
  const uint8_t* vals;
};

void derive(const HuffTable& t, bool dc, Derived* d) {
  if (!t.defined) bad();
  int size[257], code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = t.bits[l];
    if (p + n > 256) bad();
    while (n--) size[p++] = l;
  }
  size[p] = 0;
  const int nsym = p;
  int c = 0, si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1 << si)) bad();  // no code may be all ones
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      d->valoffset[l] = p - code[p];
      p += t.bits[l];
      d->maxcode[l] = code[p - 1];
    } else {
      d->maxcode[l] = -1;
    }
  }
  d->valoffset[17] = 0;
  d->maxcode[17] = 0xFFFFF;
  std::memset(d->look, 0, sizeof(d->look));
  for (int i = 0; i < nsym; ++i) {
    if (size[i] > kLookBits) break;
    int shift = kLookBits - size[i];
    for (int k = 0; k < (1 << shift); ++k)
      d->look[(code[i] << shift) | k] = static_cast<uint16_t>((size[i] << 8) | t.vals[i]);
  }
  if (dc) {
    for (int i = 0; i < nsym; ++i)
      if (t.vals[i] > 15) bad();
  }
  d->vals = t.vals;
}

// Entropy-coded bits, MSB first. A marker (or the end of the data, which
// libjpeg's memory source turns into EOI) ends the data: past it the
// reader gives zero bits and flags the segment as short of data.
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t acc = 0;  // valid bits left-aligned
  int n = 0;         // real bits in acc
  int marker = 0;    // the marker code that ended the data, 0 before one
  bool insufficient = false;

  void fill() {
    while (n <= 56 && !marker) {
      if (p >= end) {
        marker = 0xD9;
        break;
      }
      uint32_t b = *p;
      if (b == 0xFF) {
        const uint8_t* q = p + 1;
        while (q < end && *q == 0xFF) ++q;
        if (q < end && *q == 0) {
          p = q + 1;
        } else {
          marker = q < end ? *q : 0xD9;
          p = q < end ? q + 1 : end;
          break;
        }
      } else {
        ++p;
      }
      acc |= static_cast<uint64_t>(b) << (56 - n);
      n += 8;
    }
  }
  void consume(int k) {
    acc <<= k;
    if (k > n) {
      insufficient = true;
      n = 0;
    } else {
      n -= k;
    }
  }
  int bits(int k) {  // 0 < k <= 16
    if (n < k) fill();
    int v = static_cast<int>(acc >> (64 - k));
    consume(k);
    return v;
  }
  int bit() { return bits(1); }
  int decode(const Derived& d) {
    if (n < 16) fill();
    int e = d.look[acc >> (64 - kLookBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(acc >> (64 - l));
    while (code > d.maxcode[l]) {
      ++l;
      code = static_cast<int32_t>(acc >> (64 - l));
      if (l == 17) break;
    }
    if (l > 16) {  // garbage: libjpeg fakes a zero after 17 bits
      consume(17);
      return 0;
    }
    consume(l);
    return d.vals[code + d.valoffset[l]];
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ------------------------------------------------------------- decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;  // blocks of a non-interleaved scan
  int bw = 0, bh = 0;    // blocks held (whole MCUs)
  bool latched = false;  // quant table latched at the first scan, as libjpeg does
  uint16_t q[64] = {};   // natural order
  std::vector<int16_t> coef;
  int dc_tbl = 0, ac_tbl = 0, dc_pred = 0;
  int16_t* block(int bx, int by) { return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64; }
};

struct Decoder {
  const uint8_t* d;
  size_t len, pos = 0;
  int width = 0, height = 0, ncomp = 0, precision = 0;
  bool progressive = false, sof = false, multi_scan = false;
  int max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  Component comp[10];
  uint16_t qt[4][64] = {};
  bool qt_def[4] = {};
  HuffTable dc_t[4], ac_t[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int unread_marker = 0;
  // The current scan.
  int scan_n = 0, scan_comp[4] = {}, ss = 0, se = 0, ah = 0, al = 0;
  int next_restart = 0;

  Decoder(const uint8_t* data, size_t n) : d(data), len(n) {
    for (int i = 0; i < 2; ++i) {  // jstdhuff.c: used where a stream has no DHT
      dc_t[i].defined = ac_t[i].defined = true;
      std::memcpy(dc_t[i].bits, kDcBits[i], 17);
      std::memcpy(ac_t[i].bits, kAcBits[i], 17);
      for (int k = 0; k < 12; ++k) dc_t[i].vals[k] = static_cast<uint8_t>(k);
      std::memcpy(ac_t[i].vals, kAcVals[i], 162);
    }
  }

  // Past the end, libjpeg's memory source repeats a fake EOI (FF D9):
  // a segment cut short reads those bytes, and may still parse.
  int byte() {
    if (pos < len) return d[pos++];
    return (pos++ - len) % 2 ? 0xD9 : 0xFF;
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  // jdmarker.c next_marker: skip to an FF, past fill FFs, past FF/00.
  int next_marker() {
    for (;;) {
      while (pos < len && d[pos] != 0xFF) ++pos;
      while (pos < len && d[pos] == 0xFF) ++pos;
      if (pos >= len) return 0xD9;  // the memory source's fake EOI
      int c = d[pos++];
      if (c) return c;
    }
  }
  int take_marker() {
    int m = unread_marker ? unread_marker : next_marker();
    unread_marker = 0;
    return m;
  }
  void skip_variable() {
    int n = u16() - 2;
    if (n > 0) pos += static_cast<size_t>(n);
  }

  void get_sof(bool prog) {
    if (sof) bad();
    int length = u16();
    precision = byte();
    height = u16();
    width = u16();
    ncomp = byte();
    if (height <= 0 || width <= 0 || ncomp <= 0) bad();
    if (length != ncomp * 3 + 8) bad();
    if (ncomp > 10) bad();
    for (int i = 0; i < ncomp; ++i) {
      comp[i].id = byte();
      int hv = byte();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = byte();
    }
    progressive = prog;
    sof = true;
  }
  void get_dqt() {
    int length = u16() - 2;
    while (length > 0) {
      int pq = byte();
      int t = pq & 15, prec = pq >> 4;
      if (t >= 4) bad();
      for (int i = 0; i < 64; ++i)
        qt[t][kNatural[i]] = static_cast<uint16_t>(prec ? u16() : byte());
      qt_def[t] = true;
      length -= prec ? 129 : 65;
    }
    if (length != 0) bad();
  }
  void get_dht() {
    int length = u16() - 2;
    while (length > 16) {
      int index = byte();
      uint8_t bits[17] = {};
      int count = 0;
      for (int i = 1; i <= 16; ++i) count += bits[i] = static_cast<uint8_t>(byte());
      length -= 17;
      if (count > 256 || count > length) bad();
      HuffTable* t = index & 0x10 ? ac_t : dc_t;
      index &= ~0x10;
      if (index < 0 || index >= 4) bad();
      HuffTable& h = t[index];
      std::memcpy(h.bits, bits, 17);
      std::memset(h.vals, 0, sizeof(h.vals));
      for (int i = 0; i < count; ++i) h.vals[i] = static_cast<uint8_t>(byte());
      h.defined = true;
      length -= count;
    }
    if (length != 0) bad();
  }
  void get_dri() {
    if (u16() != 4) bad();
    restart_interval = u16();
  }
  // APP0 (JFIF) and APP14 (Adobe), as jdmarker.c examines them.
  void get_app(int m) {
    int length = std::max(u16() - 2, 0);
    size_t start = pos;
    size_t avail = pos < len ? std::min<size_t>(static_cast<size_t>(length), len - pos) : 0;
    const uint8_t* p = d + pos;
    if (m == 0xE0 && avail >= 14 && !std::memcmp(p, "JFIF\0", 5)) jfif = true;
    if (m == 0xEE && avail >= 12 && !std::memcmp(p, "Adobe", 5)) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos = start + static_cast<size_t>(length);
  }
  void get_sos() {
    if (!sof) bad();
    int length = u16();
    int n = byte();
    if (length != n * 2 + 6 || n < 1 || n > 4) bad();
    for (int i = 0; i < n; ++i) {
      int cc = byte(), c = byte();
      int ci = 0;
      while (ci < ncomp && comp[ci].id != cc) ++ci;
      if (ci == ncomp) bad();
      for (int j = 0; j < i; ++j)
        if (scan_comp[j] == ci) bad();
      scan_comp[i] = ci;
      comp[ci].dc_tbl = c >> 4;
      comp[ci].ac_tbl = c & 15;
    }
    ss = byte();
    se = byte();
    int a = byte();
    ah = a >> 4;
    al = a & 15;
    scan_n = n;
    next_restart = 0;
  }
  // jdinput.c initial_setup, at the first SOS.
  void initial_setup() {
    if (height > 65500 || width > 65500) bad();
    if (precision != 8) bad();
    max_h = max_v = 1;
    for (int i = 0; i < ncomp; ++i) {
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4) bad();
      max_h = std::max(max_h, comp[i].h);
      max_v = std::max(max_v, comp[i].v);
    }
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.wib = static_cast<int>((int64_t{width} * c.h + 8 * max_h - 1) / (8 * max_h));
      c.hib = static_cast<int>((int64_t{height} * c.v + 8 * max_v - 1) / (8 * max_v));
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
    }
    multi_scan = scan_n < ncomp || progressive;
  }

  // jpeg_read_header: the markers up to the first SOS. Fails where
  // libjpeg fails; returns with the first scan's header read.
  void read_header() {
    if (len < 2 || d[0] != 0xFF || d[1] != 0xD8) bad();
    pos = 2;
    for (;;) {
      int m = take_marker();
      if (m == 0xDA) {
        get_sos();
        initial_setup();
        return;
      }
      if (m == 0xD9) bad();  // no image
      marker(m);
    }
  }
  // The markers other than SOS and EOI (jdmarker.c read_markers).
  void marker(int m) {
    switch (m) {
      case 0xC0: case 0xC1: get_sof(false); break;
      case 0xC2: get_sof(true); break;
      case 0xC4: get_dht(); break;
      case 0xDB: get_dqt(); break;
      case 0xDD: get_dri(); break;
      case 0xCC: case 0xDC: skip_variable(); break;  // DAC, DNL
      case 0xE0: case 0xEE: get_app(m); break;
      case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
      case 0xD7: break;  // TEM, RSTn: no parameters
      default:
        if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE) {  // APPn, COM
          skip_variable();
          break;
        }
        // SOF3/5-7/9-11/13-15 (lossless, hierarchical, arithmetic), JPG,
        // a second SOI, unknown markers.
        bad();
    }
  }

  // ---------------------------------------------------------- scans

  // The MCU rows of the first scan that the output needs, for a
  // single-scan image (decoding stops there); -1 = all.
  int row_limit = -1;

  void decode_all() {
    decode_scan();
    if (!multi_scan) return;  // libjpeg reads no further markers
    for (;;) {
      int m = take_marker();
      if (m == 0xD9) return;
      if (m == 0xDA) {
        get_sos();
        decode_scan();
      } else {
        marker(m);
      }
    }
  }

  // Zeroed coefficients for a component: the block rows that a
  // single-scan image decodes up to `row_limit`, else all of them. Images
  // whose coefficients would pass 2 GiB fail, not the process.
  void hold(Component& c) {
    if (!c.coef.empty()) return;
    int rows = c.bh;
    if (row_limit >= 0 && !multi_scan)
      rows = std::min(rows, ncomp == 1 ? row_limit : row_limit * c.v);
    const size_t n = static_cast<size_t>(c.bw) * rows * 64;
    if (n * sizeof(int16_t) > (size_t{1} << 31)) bad();
    c.coef.assign(n, 0);
  }

  void latch(Component& c) {
    if (c.latched) return;
    if (c.tq >= 4 || !qt_def[c.tq]) bad();
    std::memcpy(c.q, qt[c.tq], sizeof(c.q));
    c.latched = true;
  }

  void decode_scan() {
    int blocks = 0;
    for (int i = 0; i < scan_n; ++i) blocks += comp[scan_comp[i]].h * comp[scan_comp[i]].v;
    if (scan_n > 1 && blocks > 10) bad();
    for (int i = 0; i < scan_n; ++i) {
      Component& c = comp[scan_comp[i]];
      latch(c);
      hold(c);
      c.dc_pred = 0;
    }
    Derived dct[4], act[4];
    const bool dc_band = ss == 0;
    if (progressive) {
      bool wrong = dc_band ? se != 0 : (ss > se || se > 63 || scan_n != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) wrong = true;
      if (wrong) bad();
      for (int i = 0; i < scan_n; ++i) {
        Component& c = comp[scan_comp[i]];
        if (dc_band) {
          if (ah == 0) {
            if (c.dc_tbl >= 4) bad();
            derive(dc_t[c.dc_tbl], true, &dct[c.dc_tbl]);
          }
        } else {
          if (c.ac_tbl >= 4) bad();
          derive(ac_t[c.ac_tbl], false, &act[c.ac_tbl]);
        }
      }
    } else {
      for (int i = 0; i < scan_n; ++i) {
        Component& c = comp[scan_comp[i]];
        if (c.dc_tbl >= 4 || c.ac_tbl >= 4) bad();
        derive(dc_t[c.dc_tbl], true, &dct[c.dc_tbl]);
        derive(ac_t[c.ac_tbl], false, &act[c.ac_tbl]);
      }
    }
    BitReader br;
    br.p = d + std::min(pos, len);
    br.end = d + len;
    int eobrun = 0;
    int restarts_to_go = restart_interval;

    auto restart = [&]() {
      // jdhuff.c process_restart + jdmarker.c read_restart_marker.
      int m;
      if (br.marker) {
        m = br.marker;
        pos = static_cast<size_t>(br.p - d);
      } else {
        pos = static_cast<size_t>(br.p - d);
        m = next_marker();
      }
      int want = 0xD0 + next_restart;
      int pending = 0;
      if (m != want) pending = resync(m, next_restart);
      next_restart = (next_restart + 1) & 7;
      for (int i = 0; i < scan_n; ++i) comp[scan_comp[i]].dc_pred = 0;
      eobrun = 0;
      restarts_to_go = restart_interval;
      br.acc = 0;
      br.n = 0;
      br.p = d + std::min(pos, len);
      br.marker = pending;
      if (!pending) br.insufficient = false;
    };

    auto seq_block = [&](Component& c, int16_t* blk) {
      int s = br.decode(dct[c.dc_tbl]);
      if (s) s = extend(br.bits(s), s);
      c.dc_pred = static_cast<int>(static_cast<uint32_t>(c.dc_pred) + static_cast<uint32_t>(s));
      blk[0] = static_cast<int16_t>(c.dc_pred);
      const Derived& ac = act[c.ac_tbl];
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    };
    auto dc_first = [&](Component& c, int16_t* blk) {
      int s = br.decode(dct[c.dc_tbl]);
      if (s) s = extend(br.bits(s), s);
      c.dc_pred = static_cast<int>(static_cast<uint32_t>(c.dc_pred) + static_cast<uint32_t>(s));
      blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_pred) << al);
    };
    auto dc_refine = [&](Component&, int16_t* blk) {
      if (br.bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
    };
    auto ac_first = [&](Component& c, int16_t* blk) {
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      const Derived& ac = act[c.ac_tbl];
      for (int k = ss; k <= se; ++k) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          const uint32_t v = static_cast<uint32_t>(extend(br.bits(s), s));
          blk[kNatural[k]] = static_cast<int16_t>(v << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          --eobrun;
          break;
        }
      }
    };
    auto ac_refine = [&](Component& c, int16_t* blk) {
      const int p1 = 1 << al, m1 = -1 * (1 << al);
      const Derived& ac = act[c.ac_tbl];
      int k = ss;
      auto correct = [&](int16_t* coef) {
        if (br.bit() && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
      };
      if (eobrun == 0) {
        for (; k <= se; ++k) {
          int rs = br.decode(ac);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            s = br.bit() ? p1 : m1;  // a newly nonzero coefficient is +-1 << al
          } else if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += br.bits(r);
            break;
          }
          do {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0) {
              correct(coef);
            } else if (--r < 0) {
              break;
            }
            ++k;
          } while (k <= se);
          if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
      if (eobrun > 0) {
        for (; k <= se; ++k) {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) correct(coef);
        }
        --eobrun;
      }
    };

    auto run = [&](auto&& block_fn) {
      if (scan_n == 1) {
        Component& c = comp[scan_comp[0]];
        int rows = c.hib;
        if (row_limit >= 0 && !multi_scan) rows = std::min(rows, row_limit);
        for (int by = 0; by < rows; ++by) {
          for (int bx = 0; bx < c.wib; ++bx) {
            if (restart_interval) {
              if (restarts_to_go == 0) restart();
              --restarts_to_go;
            }
            if (!br.insufficient) block_fn(c, c.block(bx, by));
          }
        }
        return;
      }
      int rows = mcus_y;
      if (row_limit >= 0 && !multi_scan) rows = std::min(rows, row_limit);
      for (int my = 0; my < rows; ++my) {
        for (int mx = 0; mx < mcus_x; ++mx) {
          if (restart_interval) {
            if (restarts_to_go == 0) restart();
            --restarts_to_go;
          }
          if (br.insufficient) continue;
          for (int i = 0; i < scan_n; ++i) {
            Component& c = comp[scan_comp[i]];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h) block_fn(c, c.block(mx * c.h + h, my * c.v + v));
          }
        }
      }
    };
    if (!progressive) run(seq_block);
    else if (dc_band && ah == 0) run(dc_first);
    else if (dc_band) run(dc_refine);
    else if (ah == 0) run(ac_first);
    else run(ac_refine);
    pos = static_cast<size_t>(br.p - d);
    unread_marker = br.marker;
  }

  // jdmarker.c jpeg_resync_to_restart: returns the marker left unread
  // (0 when the marker was consumed and decoding resumes).
  int resync(int m, int desired) {
    for (;;) {
      int action;
      if (m < 0xC0) action = 2;
      else if (m < 0xD0 || m > 0xD7) action = 3;
      else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) action = 3;
      else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) action = 2;
      else action = 1;
      if (action == 1) return 0;
      if (action == 3) return m;
      m = next_marker();
    }
  }
};

// ------------------------------------------------------------ output

// A component's path from its IDCT output to the output grid
// (jdsample.c jinit_upsampler's choice).
enum Mode { FULL, H2V1, H1V2, H2V2, REPLICATE };

struct Plane {
  int ss = 8;          // the component's IDCT size (1, 2, 4, 8)
  int dw = 0, dh = 0;  // downsampled width/height: its real samples
  Mode mode = FULL;
  int rh = 1, rv = 1;  // replication factors
  int cy0 = 0, cy1 = 0, cx0 = 0, cx1 = 0;  // samples needed, inclusive
  int bx0 = 0, by0 = 0, stride = 0;
  std::vector<uint8_t> px;
  // Row y of the component, from its first held column (bx0 * ss).
  const uint8_t* row(int y) const { return px.data() + static_cast<size_t>(y - by0 * ss) * stride; }
};

// Decoded window: `rgb` holds rows [oy0, oy0+h) x cols [ox0, ox0+w) of
// the 1/denom-scaled image.
struct Window {
  std::vector<uint8_t> rgb;
  int oy0 = 0, ox0 = 0, h = 0, w = 0;  // window placement, scaled coords
  int sh = 0, sw = 0;                  // full scaled image dims
};

// Decode rows [wy0, wy0+wh) x cols [wx0, wx0+ww) of the image DCT-scaled
// by 1/denom (the request clamped to the frame, the whole frame when
// nothing of it is left). Throws BadJpeg where libjpeg fails.
void decode_window(Decoder& dec, int denom, int wy0, int wh, int wx0, int ww, Window* win) {
  if (dec.ncomp != 1 && dec.ncomp != 3) bad();  // CMYK/YCCK and others: no RGB conversion
  const int min_ss = 8 / denom;
  const int sh = static_cast<int>((int64_t{dec.height} * min_ss + 7) / 8);
  const int sw = static_cast<int>((int64_t{dec.width} * min_ss + 7) / 8);
  if (wy0 < 0) wy0 = 0;
  if (wx0 < 0) wx0 = 0;
  if (wy0 + wh > sh) wh = sh - wy0;
  if (wx0 + ww > sw) ww = sw - wx0;
  if (wh <= 0 || ww <= 0) {
    wy0 = wx0 = 0;
    wh = sh;
    ww = sw;
  }
  const int y1 = wy0 + wh - 1, x1 = wx0 + ww - 1;
  Plane planes[3];
  int mcu_rows = 0;
  for (int ci = 0; ci < dec.ncomp; ++ci) {
    const Component& c = dec.comp[ci];
    Plane& p = planes[ci];
    int s = min_ss;  // jdmaster.c: scale chroma up by the IDCT where it can
    while (s < 8 && (dec.max_h * min_ss) % (c.h * s * 2) == 0 &&
           (dec.max_v * min_ss) % (c.v * s * 2) == 0)
      s *= 2;
    p.ss = s;
    p.dw = static_cast<int>((int64_t{dec.width} * c.h * s + dec.max_h * 8 - 1) / (dec.max_h * 8));
    p.dh = static_cast<int>((int64_t{dec.height} * c.v * s + dec.max_v * 8 - 1) / (dec.max_v * 8));
    const int h_in = c.h * s / min_ss, v_in = c.v * s / min_ss;
    const int h_out = dec.max_h, v_out = dec.max_v;
    const bool fancy = min_ss > 1;
    if (h_in == h_out && v_in == v_out) {
      p.mode = FULL;
    } else if (h_in * 2 == h_out && v_in == v_out) {
      p.mode = fancy && p.dw > 2 ? H2V1 : REPLICATE;
    } else if (h_in == h_out && v_in * 2 == v_out && fancy) {
      p.mode = H1V2;
    } else if (h_in * 2 == h_out && v_in * 2 == v_out) {
      p.mode = fancy && p.dw > 2 ? H2V2 : REPLICATE;
    } else if (h_out % h_in == 0 && v_out % v_in == 0) {
      p.mode = REPLICATE;
    } else {
      bad();  // fractional sampling ratios
    }
    p.rh = h_out / h_in;
    p.rv = v_out / v_in;
    const bool ctx_v = p.mode == H1V2 || p.mode == H2V2;
    const bool ctx_h = p.mode == H2V1 || p.mode == H2V2;
    p.cy0 = ctx_v ? wy0 / 2 - 1 : wy0 / p.rv;
    p.cy1 = ctx_v ? y1 / 2 + 1 : y1 / p.rv;
    p.cx0 = ctx_h ? wx0 / 2 - 1 : wx0 / p.rh;
    p.cx1 = ctx_h ? x1 / 2 + 1 : x1 / p.rh;
    p.cy0 = std::max(p.cy0, 0);
    p.cx0 = std::max(p.cx0, 0);
    p.cy1 = std::min(p.cy1, p.dh - 1);
    p.cx1 = std::min(p.cx1, p.dw - 1);
    p.by0 = p.cy0 / s;
    p.bx0 = p.cx0 / s;
    const int by1 = p.cy1 / s;
    mcu_rows = std::max(mcu_rows, by1 / c.v + 1);
  }
  // A single-scan image stops decoding after the window's last MCU row
  // (one block row of a lone component).
  dec.row_limit = dec.ncomp == 1 ? planes[0].cy1 / planes[0].ss + 1 : mcu_rows;
  dec.decode_all();

  for (int ci = 0; ci < dec.ncomp; ++ci) {
    Component& c = dec.comp[ci];
    Plane& p = planes[ci];
    const int s = p.ss;
    const int by1 = p.cy1 / s, bx1 = p.cx1 / s;
    p.stride = (bx1 - p.bx0 + 1) * s;
    p.px.assign(static_cast<size_t>(by1 - p.by0 + 1) * s * p.stride, 0);
    dec.hold(c);  // a component no scan reached: all zeros
    void (*idct)(const int16_t*, const uint16_t*, uint8_t*, int) =
        s == 8 ? idct_8x8 : s == 4 ? idct_4x4 : s == 2 ? idct_2x2 : idct_1x1;
    for (int by = p.by0; by <= by1; ++by)
      for (int bx = p.bx0; bx <= bx1; ++bx)
        idct(c.block(bx, by), c.q,
             p.px.data() + static_cast<size_t>(by - p.by0) * s * p.stride + (bx - p.bx0) * s,
             p.stride);
  }

  // Upsample one output row of a component over the window's columns.
  auto upsample = [&](const Plane& p, int y, uint8_t* out) {
    switch (p.mode) {
      case FULL: {
        std::memcpy(out, p.row(y) + (wx0 - p.bx0 * p.ss), static_cast<size_t>(ww));
        break;
      }
      case REPLICATE: {
        const uint8_t* row = p.row(y / p.rv);
        const int base = p.bx0 * p.ss;
        for (int x = 0; x < ww; ++x) out[x] = row[(wx0 + x) / p.rh - base];
        break;
      }
      case H1V2: {
        const int i = y / 2, odd = y & 1;
        const int nb = std::min(std::max(odd ? i + 1 : i - 1, 0), p.dh - 1);
        const uint8_t* a = p.row(i) + (wx0 - p.bx0 * p.ss);
        const uint8_t* b = p.row(nb) + (wx0 - p.bx0 * p.ss);
        const int bias = odd ? 2 : 1;
        for (int x = 0; x < ww; ++x) out[x] = static_cast<uint8_t>((3 * a[x] + b[x] + bias) >> 2);
        break;
      }
      case H2V1: {
        const uint8_t* row = p.row(y);
        const int base = p.bx0 * p.ss;
        for (int x = 0; x < ww; ++x) {
          const int ox = wx0 + x, j = ox >> 1;
          const int v = row[j - base];
          if (ox & 1) {
            const int nb = std::min(j + 1, p.dw - 1);
            out[x] = static_cast<uint8_t>((3 * v + row[nb - base] + 2) >> 2);
          } else {
            const int nb = std::max(j - 1, 0);
            out[x] = static_cast<uint8_t>((3 * v + row[nb - base] + 1) >> 2);
          }
        }
        break;
      }
      case H2V2: {
        const int i = y / 2, odd = y & 1;
        const int nb_row = std::min(std::max(odd ? i + 1 : i - 1, 0), p.dh - 1);
        const uint8_t* a = p.row(i);
        const uint8_t* b = p.row(nb_row);
        const int base = p.bx0 * p.ss;
        auto colsum = [&](int j) { return 3 * a[j - base] + b[j - base]; };
        for (int x = 0; x < ww; ++x) {
          const int ox = wx0 + x, j = ox >> 1;
          const int here = colsum(j);
          if (ox & 1) {
            out[x] = static_cast<uint8_t>((3 * here + colsum(std::min(j + 1, p.dw - 1)) + 7) >> 4);
          } else {
            out[x] = static_cast<uint8_t>((3 * here + colsum(std::max(j - 1, 0)) + 8) >> 4);
          }
        }
        break;
      }
    }
  };

  // jdapimin.c default_decompress_parms: the JPEG colour space.
  bool rgb_space = false;
  if (dec.ncomp == 3 && !dec.jfif) {
    if (dec.adobe) {
      rgb_space = dec.adobe_transform == 0;
    } else {
      rgb_space = dec.comp[0].id == 82 && dec.comp[1].id == 71 && dec.comp[2].id == 66;
    }
  }
  win->rgb.resize(static_cast<size_t>(wh) * ww * 3);
  std::vector<uint8_t> rows(static_cast<size_t>(ww) * 3);
  uint8_t* r0 = rows.data();
  uint8_t* r1 = r0 + ww;
  uint8_t* r2 = r1 + ww;
  for (int y = 0; y < wh; ++y) {
    uint8_t* dst = win->rgb.data() + static_cast<size_t>(y) * ww * 3;
    upsample(planes[0], wy0 + y, r0);
    if (dec.ncomp == 1) {
      for (int x = 0; x < ww; ++x) dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = r0[x];
      continue;
    }
    upsample(planes[1], wy0 + y, r1);
    upsample(planes[2], wy0 + y, r2);
    if (rgb_space) {
      for (int x = 0; x < ww; ++x) {
        dst[3 * x] = r0[x];
        dst[3 * x + 1] = r1[x];
        dst[3 * x + 2] = r2[x];
      }
      continue;
    }
    for (int x = 0; x < ww; ++x) {
      const int yy = r0[x], cb = r1[x], cr = r2[x];
      dst[3 * x] = clamp255(yy + kColor.cr_r[cr]);
      dst[3 * x + 1] = clamp255(yy + static_cast<int>((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
      dst[3 * x + 2] = clamp255(yy + kColor.cb_b[cb]);
    }
  }
  win->oy0 = wy0;
  win->ox0 = wx0;
  win->h = wh;
  win->w = ww;
  win->sh = sh;
  win->sw = sw;
}

// ---------------------------------------------------------- crop policy
// (native/fastjpeg.cpp's, unchanged)

struct Crop {
  int y0, x0, h, w;  // in ORIGINAL image coordinates
  bool flip;
};

// Draw order is the contract with the numpy mirror: per attempt
// (u_area, u_logratio), then on success (u_y, u_x); after the loop
// u_flip. Mirrors torchvision RandomResizedCrop semantics.
Crop train_crop(int H, int W, SplitMix64* rng) {
  const double log_lo = std::log(3.0 / 4.0), log_hi = std::log(4.0 / 3.0);
  Crop c{};
  bool found = false;
  for (int attempt = 0; attempt < 10 && !found; ++attempt) {
    double a_frac = 0.08 + rng->u01() * 0.92;
    double ratio = std::exp(log_lo + rng->u01() * (log_hi - log_lo));
    double area = a_frac * H * W;
    int w = static_cast<int>(std::floor(std::sqrt(area * ratio) + 0.5));
    int h = static_cast<int>(std::floor(std::sqrt(area / ratio) + 0.5));
    if (w >= 1 && h >= 1 && w <= W && h <= H) {
      c.y0 = static_cast<int>(std::floor(rng->u01() * (H - h + 1)));
      c.x0 = static_cast<int>(std::floor(rng->u01() * (W - w + 1)));
      c.h = h;
      c.w = w;
      found = true;
    }
  }
  if (!found) {  // fallback: central min-square (matches the mirror)
    int m = H < W ? H : W;
    c.h = c.w = m;
    c.y0 = (H - m) / 2;
    c.x0 = (W - m) / 2;
  }
  c.flip = rng->u01() < 0.5;
  return c;
}

Crop eval_crop(int H, int W) {
  int m = H < W ? H : W;
  int crop = static_cast<int>(0.875 * m);
  if (crop < 1) crop = 1;
  return Crop{(H - crop) / 2, (W - crop) / 2, crop, crop, false};
}

// Largest DCT denom in {8,4,2,1} that keeps the scaled crop >= out so
// the bilinear stage only ever downsamples.
int pick_denom(const Crop& c, int out) {
  for (int d : {8, 4, 2}) {
    if (c.h / d >= out && c.w / d >= out) return d;
  }
  return 1;
}

// Bilinear-sample the crop (original coords) from a decoded window of
// the 1/denom-scaled image, flip, normalize, write [out, out, 3]
// floats. Sample indices are computed in scaled-IMAGE coordinates and
// only then rebased into the window, whose one-pixel margin covers the
// bilinear neighbors.
void resize_normalize(const Window& win, int denom, const Crop& c, int out,
                      const float* mean, const float* inv_std, float* dst) {
  const double inv_d = 1.0 / denom;
  const int sh = win.sh, sw = win.sw;
  auto rebase_y = [&](int y) {
    y -= win.oy0;
    if (y < 0) y = 0;
    if (y >= win.h) y = win.h - 1;
    return y;
  };
  auto rebase_x = [&](int x) {
    x -= win.ox0;
    if (x < 0) x = 0;
    if (x >= win.w) x = win.w - 1;
    return x;
  };
  for (int oy = 0; oy < out; ++oy) {
    double sy = c.y0 + (oy + 0.5) * c.h / out - 0.5;
    double sys = (sy + 0.5) * inv_d - 0.5;
    int y1 = static_cast<int>(std::floor(sys));
    double fy = sys - y1;
    int y2 = y1 + 1;
    if (y1 < 0) y1 = 0;
    if (y2 < 0) y2 = 0;
    if (y1 >= sh) y1 = sh - 1;
    if (y2 >= sh) y2 = sh - 1;
    int by1 = rebase_y(y1), by2 = rebase_y(y2);
    for (int ox = 0; ox < out; ++ox) {
      int ox_dst = c.flip ? (out - 1 - ox) : ox;
      double sx = c.x0 + (ox + 0.5) * c.w / out - 0.5;
      double sxs = (sx + 0.5) * inv_d - 0.5;
      int x1 = static_cast<int>(std::floor(sxs));
      double fx = sxs - x1;
      int x2 = x1 + 1;
      if (x1 < 0) x1 = 0;
      if (x2 < 0) x2 = 0;
      if (x1 >= sw) x1 = sw - 1;
      if (x2 >= sw) x2 = sw - 1;
      int bx1 = rebase_x(x1), bx2 = rebase_x(x2);
      const uint8_t* base = win.rgb.data();
      const uint8_t* p11 = base + (static_cast<size_t>(by1) * win.w + bx1) * 3;
      const uint8_t* p12 = base + (static_cast<size_t>(by1) * win.w + bx2) * 3;
      const uint8_t* p21 = base + (static_cast<size_t>(by2) * win.w + bx1) * 3;
      const uint8_t* p22 = base + (static_cast<size_t>(by2) * win.w + bx2) * 3;
      float* q = dst + (static_cast<size_t>(oy) * out + ox_dst) * 3;
      for (int k = 0; k < 3; ++k) {
        double v = (1 - fy) * ((1 - fx) * p11[k] + fx * p12[k]) +
                   fy * ((1 - fx) * p21[k] + fx * p22[k]);
        q[k] = (static_cast<float>(v) * (1.0f / 255.0f) - mean[k]) * inv_std[k];
      }
    }
  }
}

// One image through the stage; false where the decode fails.
bool decode_augment_one(const uint8_t* img, size_t len, bool train, uint64_t seed, int out_size,
                        const float* mean, const float* inv_std, float* dst) {
  try {
    Decoder dec(img, len);
    dec.read_header();
    const int H = dec.height, W = dec.width;
    Crop c;
    if (train) {
      SplitMix64 rng(seed);
      c = train_crop(H, W, &rng);
    } else {
      c = eval_crop(H, W);
    }
    int denom = pick_denom(c, out_size);
    // Scaled-coordinate window covering the crop plus a one-pixel
    // bilinear margin; decode_window clamps it to the frame.
    int wy0 = c.y0 / denom - 1;
    int wh = (c.y0 + c.h + denom - 1) / denom - wy0 + 2;
    int wx0 = c.x0 / denom - 1;
    int ww = (c.x0 + c.w + denom - 1) / denom - wx0 + 2;
    Window win;
    decode_window(dec, denom, wy0, wh, wx0, ww, &win);
    resize_normalize(win, denom, c, out_size, mean, inv_std, dst);
    return true;
  } catch (const BadJpeg&) {
    return false;
  } catch (const std::bad_alloc&) {
    return false;
  }
}

}  // namespace

extern "C" {

// Returns the number of FAILED decodes (0 == all good). Failed images
// get ok_flags[i] = 0 and a zeroed output slot.
int64_t fj_decode_augment_batch(const uint8_t* data, const int64_t* offsets, int64_t n,
                                int32_t train, int32_t out_size, const uint64_t* seeds,
                                const float* mean, const float* inv_std, float* out,
                                int64_t threads, uint8_t* ok_flags) {
  std::vector<int64_t> failures(n > 0 ? n : 1, 0);
  parallel_for(n, static_cast<int>(threads), [&](int64_t i) {
    const uint8_t* img = data + offsets[i];
    size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    float* dst = out + static_cast<size_t>(i) * out_size * out_size * 3;
    bool ok = decode_augment_one(img, len, train != 0, train ? seeds[i] : 0, out_size, mean,
                                 inv_std, dst);
    if (!ok) {
      std::memset(dst, 0, sizeof(float) * out_size * out_size * 3);
      failures[i] = 1;
    }
    ok_flags[i] = ok ? 1 : 0;
  });
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) total += failures[i];
  return total;
}

int32_t fj_jpeg_dims(const uint8_t* data, int64_t len, int32_t* h, int32_t* w) {
  try {
    Decoder dec(data, static_cast<size_t>(len));
    dec.read_header();
    *h = dec.height;
    *w = dec.width;
    return 0;
  } catch (const BadJpeg&) {
    return 1;
  }
}

// The whole image DCT-scaled by 1/denom (1, 2, 4 or 8) as uint8 RGB
// into `out` (capacity `cap` bytes); its size in *h, *w. Returns 0, or
// 1 where the decode fails, 2 where `out` is too small.
int32_t pj_decode_rgb(const uint8_t* data, int64_t len, int32_t denom, uint8_t* out,
                      int64_t cap, int32_t* h, int32_t* w) {
  if (denom != 1 && denom != 2 && denom != 4 && denom != 8) return 1;
  try {
    Decoder dec(data, static_cast<size_t>(len));
    dec.read_header();
    Window win;
    decode_window(dec, denom, 0, 1 << 30, 0, 1 << 30, &win);
    *h = win.h;
    *w = win.w;
    if (static_cast<int64_t>(win.rgb.size()) > cap) return 2;
    std::memcpy(out, win.rgb.data(), win.rgb.size());
    return 0;
  } catch (const BadJpeg&) {
    return 1;
  } catch (const std::bad_alloc&) {
    return 1;
  }
}

}  // extern "C"
