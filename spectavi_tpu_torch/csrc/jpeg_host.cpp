// JPEG codec for the host, with a plain C interface for ctypes.
//
// The decoder reads Huffman JPEG at 8 bits, sequential (SOF0 and SOF1)
// or progressive (SOF2), with 1 component (gray) or 3 (YCbCr or RGB) at
// any integral sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...),
// and gives exactly the pixels that libjpeg-turbo gives with its default
// decompression settings: the integer "islow" inverse DCT, jdsample.c's
// upsampling (fancy h2v1, h1v2 and h2v2, else sample replication) and the
// fixed-point YCbCr->RGB tables.  All of that is integer arithmetic, so
// it is reproduced here step for step.  A progressive file is read scan
// by scan into whole-image coefficient buffers (jdphuff.c's four scan
// kinds) and output after its last scan; where its scans leave one of
// the first nine AC coefficients unrefined, the blocks are smoothed
// first, as libjpeg-turbo's jdcoefct.c smooths them (held to 3.1.3).
// Reported as "not mine", for the caller to hand to another decoder:
// arithmetic coding, lossless, hierarchical and 12-bit JPEG, 2 or 4
// components (CMYK, YCCK) and non-integral sampling factors.  A
// malformed file is reported as an error; every read of the input is
// bounds-checked.
//
// The encoder writes what libjpeg-turbo writes with its defaults (as
// Pillow's ``Image.save`` calls it): the JFIF APP0 header, baseline
// tables scaled to the quality as ``jpeg_set_quality`` scales them, the
// Annex K Huffman tables, 4:2:0 for RGB and one component for gray, the
// integer forward DCT and libjpeg-turbo's reciprocal quantizer.

#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Malformed {
  std::string msg;
};
struct NotMine {
  std::string msg;
};

[[noreturn]] void bad(const std::string& m) { throw Malformed{m}; }
[[noreturn]] void not_mine(const std::string& m) { throw NotMine{m}; }

// zigzag position -> natural (row-major) position
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// block smoothing (jdcoefct.c): the coefficients it estimates, zigzag
// 0-9, and its 5x5 kernels over the DC values around a block (row-major,
// the block at the centre) for zigzag 1-9, without and with "change DC"
// (no AC coded yet); without it only zigzag 1-5 are estimated
constexpr int kSmoothed = 10;
const int8_t kSmoothKernel[2][kSmoothed][25] = {
    {{},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
     {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
     {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {}, {}, {}, {}},
    {{},
     {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
     {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
     {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
     {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
     {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}}};
// the "change DC" estimate of the DC itself (the weights sum to 256)
const int16_t kSmoothDc[25] = {-2, -6,  -8, -6, -2, -6, 6,  42,  6,  -6, -8, 42, 152,
                               42, -8, -6, 6,  42, 6,  -6, -2, -6, -8, -6, -2};

// Annex K.3 Huffman tables: code counts by length 1-16, then symbols
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
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
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
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
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Annex K.1 quantization tables, natural order
const int kStdLumQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChrQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// the islow DCTs' fixed-point constants (CONST_BITS = 13)
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// the colour tables (SCALEBITS = 16)
constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t(1) << (kScaleBits - 1);
constexpr int64_t fix16(double x) { return int64_t(x * (1 << kScaleBits) + 0.5); }

struct Tables {
  // post-IDCT range limit, indexed by the result & 1023
  uint8_t idct_limit[1024];
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  // R, G, B -> Y, Cb, Cr contributions (jccolor.c's rgb_ycc_tab)
  int64_t ycc[8][256];
  Tables() {
    for (int i = 0; i < 1024; i++) {
      idct_limit[i] = uint8_t(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
    }
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix16(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = int((fix16(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix16(0.71414) * x;
      cb_g[i] = -fix16(0.34414) * x + kOneHalf;
      ycc[0][i] = fix16(0.29900) * i;
      ycc[1][i] = fix16(0.58700) * i;
      ycc[2][i] = fix16(0.11400) * i + kOneHalf;
      ycc[3][i] = -fix16(0.16874) * i;
      ycc[4][i] = -fix16(0.33126) * i;
      ycc[5][i] = fix16(0.50000) * i + (int64_t(128) << kScaleBits) + kOneHalf - 1;
      ycc[6][i] = -fix16(0.41869) * i;
      ycc[7][i] = -fix16(0.08131) * i;
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------------
// decoding

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};  // bits[l]: codes of length l
  uint8_t vals[256] = {};
  int count = 0;
};

struct HuffDecoder {
  int32_t maxcode[18];
  int32_t valoff[18];
  uint8_t vals[256];
  int count;
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol, 0: longer

  // jpeg_make_d_derived_tbl
  void build(const HuffTable& t, bool dc) {
    int size[257], code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      if (p + t.bits[l] > 256) bad("Huffman table has more than 256 codes");
      for (int i = 0; i < t.bits[l]; i++) size[p++] = l;
    }
    size[p] = 0;
    count = p;
    int64_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = int(code++);
      if (code >= (int64_t(1) << si)) bad("Huffman table's code lengths overflow");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (t.bits[l]) {
        valoff[l] = p - code_of[p];
        p += t.bits[l];
        maxcode[l] = code_of[p - 1];
      } else {
        valoff[l] = 0;
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memcpy(vals, t.vals, sizeof vals);
    std::memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < t.bits[l]; i++, p++) {
        int bits = code_of[p] << (kLookBits - l);
        for (int c = 0; c < (1 << (kLookBits - l)); c++) {
          look[bits + c] = uint16_t((l << 8) | t.vals[p]);
        }
      }
    }
    if (dc) {
      for (int i = 0; i < count; i++) {
        if (t.vals[i] > 15) bad("DC Huffman table has a symbol above 15");
      }
    }
  }
};

// zeroed coefficients, from calloc: the pages a truncated file never
// reaches are never touched
struct Coefs {
  int16_t* p = nullptr;
  Coefs() = default;
  Coefs(const Coefs&) = delete;
  Coefs& operator=(const Coefs&) = delete;
  ~Coefs() { std::free(p); }
  void allocate(size_t count) {
    std::free(p);
    p = static_cast<int16_t*>(std::calloc(count, sizeof(int16_t)));
    if (!p) throw std::bad_alloc();
  }
  void release() {
    std::free(p);
    p = nullptr;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int hr = 1, vr = 1;   // the frame's largest factors over this one's
  int w = 0, ht = 0;    // samples (downsampled size)
  int bw = 0, bh = 0;   // allocated block grid (whole MCUs)
  bool scanned = false;
  int quant[64];        // latched at its first scan, natural order
  // jdphuff.c's coef_bits: by zigzag index, -1 before any scan of the
  // coefficient, then the Al of its last scan
  int coef_bits[64];
  Coefs coef;
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
};

// MSB-first bit reader over entropy-coded data, unstuffing FF 00 and
// stopping at a marker, after which it supplies zero bits that a valid
// stream never consumes.
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0, fake = 0;
  bool at_marker = false;
  size_t marker_pos = 0;

  BitReader(const uint8_t* d_, size_t n_, size_t pos_) : d(d_), n(n_), pos(pos_) {}

  void fill() {
    while (nbits <= 56) {
      unsigned b = 0;
      if (at_marker) {
        fake += 8;
      } else if (pos >= n) {
        at_marker = true;
        marker_pos = n;
        fake += 8;
      } else if (d[pos] != 0xFF) {
        b = d[pos++];
      } else {
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) q++;
        if (q < n && d[q] == 0) {
          b = 0xFF;
          pos = q + 1;
        } else {
          at_marker = true;
          marker_pos = pos;
          fake += 8;
        }
      }
      acc |= uint64_t(b) << (56 - nbits);
      nbits += 8;
    }
  }
  void skip(int k) {
    if (k > nbits - fake) bad("JPEG entropy-coded data ends early");
    acc <<= k;
    nbits -= k;
  }
  int get(int k) {  // 1 <= k <= 16
    if (nbits < 16) fill();
    int v = int(acc >> (64 - k));
    skip(k);
    return v;
  }
  int decode(const HuffDecoder& t) {
    if (nbits < 16) fill();
    unsigned look = t.look[acc >> (64 - kLookBits)];
    if (look) {
      skip(int(look >> 8));
      return int(look & 0xFF);
    }
    int32_t code = int32_t(acc >> 48);
    int l = kLookBits + 1;
    while (l <= 16 && (code >> (16 - l)) > t.maxcode[l]) l++;
    if (l > 16) bad("bad Huffman code in JPEG data");
    int idx = (code >> (16 - l)) + t.valoff[l];
    if (idx < 0 || idx >= t.count) bad("bad Huffman code in JPEG data");
    skip(l);
    return t.vals[idx];
  }
  int extend(int s) {  // HUFF_EXTEND of the next s bits
    if (s == 0) return 0;
    int r = get(s);
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
  }
  // where to look for the marker that follows the consumed data
  size_t resume() const { return at_marker ? marker_pos : pos; }
};

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 2;
  bool have_frame = false, allocated = false, any_scan = false;
  int W = 0, H = 0, nc = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[3];
  int quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int64_t out_len = 0;

  bool progressive = false;
  // the scan being decoded: its kind, band Ss..Se, bit position Al, and
  // the blocks left in an end-of-band run (progressive AC scans)
  enum Kind { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };
  Kind kind = kSequential;
  int ss = 0, se = 63, al = 0, eobrun = 0;

  Decoder(const uint8_t* d_, size_t n_) : d(d_), n(n_) {}

  unsigned u8() {
    if (pos >= n) bad("JPEG ends inside a marker segment");
    return d[pos++];
  }
  unsigned u16() {
    unsigned hi = u8();
    return (hi << 8) | u8();
  }

  // jdmarker.c's next_marker: skip anything up to an FF, the fill FFs,
  // and FF 00 pairs; the marker code
  unsigned next_marker() {
    for (;;) {
      if (pos >= n) bad("JPEG ends before its EOI marker");
      unsigned c = d[pos++];
      if (c != 0xFF) continue;
      do {
        if (pos >= n) bad("JPEG ends before its EOI marker");
        c = d[pos++];
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // the segment's payload as [start, end)
  size_t segment(size_t* end) {
    unsigned len = u16();
    if (len < 2) bad("JPEG marker segment length below 2");
    if (pos + (len - 2) > n) bad("JPEG marker segment runs past the end of the file");
    *end = pos + (len - 2);
    return pos;
  }

  void read_sof() {
    size_t end;
    segment(&end);
    unsigned prec = u8();
    H = int(u16());
    W = int(u16());
    nc = int(u8());
    if (pos + 3 * size_t(nc) != end) bad("JPEG SOF segment has the wrong length");
    if (prec != 8) not_mine("JPEG sample precision is not 8 bits");
    if (W == 0 || H == 0) bad("JPEG frame is empty");
    if (nc != 1 && nc != 3) not_mine("JPEG has neither 1 nor 3 components");
    for (int i = 0; i < nc; i++) {
      Component& c = comp[i];
      c.id = int(u8());
      unsigned hv = u8();
      c.h = int(hv >> 4);
      c.v = int(hv & 15);
      c.tq = int(u8());
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) bad("JPEG sampling factor out of 1-4");
      if (c.tq > 3) bad("JPEG quantization table index above 3");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    // jdsample.c's jinit_upsampler: every component, luma included, is
    // upsampled by the largest factors over its own; libjpeg-turbo
    // implements integral ratios only
    for (int i = 0; i < nc; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) not_mine("JPEG sampling factors with a non-integral ratio");
      c.hr = hmax / c.h;
      c.vr = vmax / c.v;
    }
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < nc; i++) {
      Component& c = comp[i];
      c.w = int((int64_t(W) * c.h + hmax - 1) / hmax);
      c.ht = int((int64_t(H) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    have_frame = true;
  }

  void read_dht() {
    size_t end;
    segment(&end);
    while (pos < end) {
      unsigned index = u8();
      bool is_ac = index & 0x10;
      index &= ~0x10u;
      if (index > 3) bad("JPEG DHT table index above 3");
      HuffTable& t = is_ac ? ac[index] : dc[index];
      if (pos + 16 > end) bad("JPEG DHT segment too short");
      int count = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; l++) {
        t.bits[l] = uint8_t(u8());
        count += t.bits[l];
      }
      if (count > 256 || pos + size_t(count) > end) bad("JPEG DHT segment has a bad code count");
      std::memset(t.vals, 0, sizeof t.vals);
      for (int i = 0; i < count; i++) t.vals[i] = uint8_t(u8());
      t.count = count;
      t.defined = true;
    }
    if (pos != end) bad("JPEG DHT segment has the wrong length");
  }

  void read_dqt() {
    size_t end;
    segment(&end);
    while (pos < end) {
      unsigned pq = u8();
      unsigned tq = pq & 15;
      pq >>= 4;
      if (tq > 3 || pq > 1) bad("JPEG DQT table index or precision out of range");
      if (pos + (pq ? 128 : 64) > end) bad("JPEG DQT segment too short");
      for (int i = 0; i < 64; i++) {
        // libjpeg keeps the multiplier as a 16-bit signed value
        int q = int(pq ? u16() : u8());
        quant[tq][kNatural[i]] = int(int16_t(q));
      }
      quant_defined[tq] = true;
    }
    if (pos != end) bad("JPEG DQT segment has the wrong length");
  }

  // APPn, COM and DNL: skipped, noting a JFIF APP0 and an Adobe APP14
  void read_app(unsigned m) {
    size_t end;
    size_t start = segment(&end);
    size_t len = end - start;
    if (m == 0xE0 && len >= 14 && std::memcmp(d + start, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && len >= 12 && std::memcmp(d + start, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[start + 11];
    }
    pos = end;
  }

  void allocate() {
    for (int i = 0; i < nc; i++) {
      Component& c = comp[i];
      c.coef.allocate(size_t(c.bw) * c.bh * 64);
    }
    allocated = true;
  }

  struct ScanComp {
    Component* c;
    HuffDecoder dc, ac;
    int pred;
  };

  const HuffTable& huff_table(bool is_ac, int id) {
    const HuffTable& t = is_ac ? ac[id] : dc[id];
    if (t.defined) return t;
    // libjpeg-turbo supplies the Annex K tables for slots 0 and 1 that
    // no DHT defined (Motion-JPEG frames carry none), to sequential
    // files only
    if (progressive) bad("JPEG progressive scan uses a Huffman table that no DHT defines");
    static HuffTable std_tables[4];
    static bool made = [] {
      const uint8_t* bits[4] = {kDcLumBits, kDcChrBits, kAcLumBits, kAcChrBits};
      const uint8_t* vals[4] = {kDcVals, kDcVals, kAcLumVals, kAcChrVals};
      for (int k = 0; k < 4; k++) {
        int count = 0;
        for (int l = 1; l <= 16; l++) {
          std_tables[k].bits[l] = bits[k][l - 1];
          count += bits[k][l - 1];
        }
        std::memcpy(std_tables[k].vals, vals[k], size_t(count));
        std_tables[k].count = count;
        std_tables[k].defined = true;
      }
      return true;
    }();
    (void)made;
    if (id > 1) bad("JPEG scan uses a Huffman table that no DHT defines");
    return std_tables[(is_ac ? 2 : 0) + id];
  }

  // the DC predictor plus a difference; libjpeg-turbo's JERR_BAD_DCT_COEF
  // where the sum leaves int
  static int add_dc(int pred, int diff) {
    int64_t v = int64_t(pred) + diff;
    if (v > INT_MAX || v < INT_MIN) bad("JPEG DC coefficient out of range");
    return int(v);
  }

  // jdhuff.c: one block of a sequential scan
  void decode_block(BitReader& br, ScanComp& s, int16_t* blk) {
    int t = br.decode(s.dc);
    s.pred = add_dc(s.pred, br.extend(t));
    blk[0] = int16_t(s.pred);
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(s.ac);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) bad("JPEG block runs past its 64 coefficients");
        blk[kNatural[k]] = int16_t(br.extend(sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c's decode_mcu_DC_first, one block
  void dc_first(BitReader& br, ScanComp& s, int16_t* blk) {
    int t = br.decode(s.dc);
    s.pred = add_dc(s.pred, br.extend(t));
    blk[0] = int16_t(unsigned(s.pred) << al);
  }

  // decode_mcu_DC_refine: one bit a block
  void dc_refine(BitReader& br, int16_t* blk) {
    if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  // the length of an end-of-band run whose symbol carries r: 2^r plus r
  // bits, this block included
  int eob_run(BitReader& br, int r) { return (1 << r) + (r ? br.get(r) : 0); }

  // decode_mcu_AC_first: the band's first pass, ending in a run of empty
  // blocks where the EOBRUN says so
  void ac_first(BitReader& br, ScanComp& s, int16_t* blk) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(s.ac);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > se) bad("JPEG block runs past its scan's band");
        blk[kNatural[k]] = int16_t(unsigned(br.extend(sz)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = eob_run(br, r) - 1;
        break;
      }
    }
  }

  // a correction bit for a coefficient that is already nonzero: 1 adds
  // 1 << Al to its magnitude, unless that bit is already set
  void correct(BitReader& br, int16_t* c) {
    int p1 = 1 << al;
    if (br.get(1) && (*c & p1) == 0) *c = int16_t(*c >= 0 ? *c + p1 : *c - p1);
  }

  // decode_mcu_AC_refine: correction bits for the band's nonzero
  // coefficients, and the new +-1 << Al ones, across EOB runs
  void ac_refine(BitReader& br, ScanComp& s, int16_t* blk) {
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(s.ac);
        int r = rs >> 4, sz = rs & 15, value = 0;
        if (sz) {
          // libjpeg-turbo only warns (JWRN_HUFF_BAD_CODE) and reads one bit
          if (sz != 1) bad("JPEG refinement scan codes a new coefficient of size above 1");
          value = br.get(1) ? (1 << al) : -(1 << al);
        } else if (r != 15) {
          eobrun = eob_run(br, r);
          break;
        }
        // pass the nonzero coefficients (each takes a correction bit) and
        // r zero ones; stop on the zero that the new coefficient fills
        for (; k <= se; k++) {
          int16_t* c = &blk[kNatural[k]];
          if (*c != 0) {
            correct(br, c);
          } else if (--r < 0) {
            break;
          }
        }
        if (value) {
          if (k > se) bad("JPEG block runs past its scan's band");
          blk[kNatural[k]] = int16_t(value);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        if (blk[kNatural[k]] != 0) correct(br, &blk[kNatural[k]]);
      }
      eobrun--;
    }
  }

  void scan_block(BitReader& br, ScanComp& s, int16_t* blk) {
    switch (kind) {
      case kSequential: decode_block(br, s, blk); break;
      case kDcFirst: dc_first(br, s, blk); break;
      case kDcRefine: dc_refine(br, blk); break;
      case kAcFirst: ac_first(br, s, blk); break;
      case kAcRefine: ac_refine(br, s, blk); break;
    }
  }

  // jdphuff.c's start_pass_phuff_decoder: the scan parameters that
  // libjpeg-turbo refuses (JERR_BAD_PROGRESSION), then coef_bits, where a
  // scan out of order (JWRN_BOGUS_PROGRESSION, only a warning there) is
  // refused too
  void start_progressive_scan(const ScanComp* sc, unsigned ns, int ah) {
    bool dc_band = ss == 0;
    bool ok = (dc_band ? se == 0 : ss <= se && se <= 63 && ns == 1) && (ah == 0 || al == ah - 1)
              && al <= 13;
    if (!ok) bad("JPEG progressive scan has a bad spectral selection or successive approximation");
    kind = dc_band ? (ah ? kDcRefine : kDcFirst) : (ah ? kAcRefine : kAcFirst);
    for (unsigned i = 0; i < ns; i++) {
      int* bits = sc[i].c->coef_bits;
      if (!dc_band && bits[0] < 0) bad("JPEG progressive AC scan before the component's DC scan");
      for (int k = ss; k <= se; k++) {
        if (ah != (bits[k] < 0 ? 0 : bits[k])) {
          bad("JPEG progressive scan does not follow the previous scan of its band");
        }
        bits[k] = al;
      }
    }
  }

  void read_sos() {
    if (!have_frame) bad("JPEG SOS before its SOF");
    size_t end;
    segment(&end);
    unsigned ns = u8();
    if (ns < 1 || ns > unsigned(nc) || end - pos != 2 * ns + 3) bad("JPEG SOS segment is invalid");
    ScanComp sc[3];
    unsigned selector[3];
    for (unsigned i = 0; i < ns; i++) {
      unsigned id = u8(), tables = u8();
      Component* c = nullptr;
      for (int k = 0; k < nc; k++) {
        if (comp[k].id == int(id)) {
          c = &comp[k];
          break;
        }
      }
      if (!c) bad("JPEG scan names a component the frame does not have");
      for (unsigned j = 0; j < i; j++) {
        if (sc[j].c == c) bad("JPEG scan names a component twice");
      }
      if (c->scanned && !progressive) bad("JPEG component coded in two scans");
      if ((tables >> 4) > 3 || (tables & 15) > 3) bad("JPEG Huffman table index above 3");
      sc[i].c = c;
      sc[i].pred = 0;
      selector[i] = tables;
    }
    // Ss, Se, Ah/Al: a sequential decoder ignores them, as libjpeg does
    ss = int(u8());
    se = int(u8());
    unsigned ahal = u8();
    al = int(ahal & 15);
    kind = kSequential;
    if (progressive) start_progressive_scan(sc, ns, int(ahal >> 4));
    // the tables the scan kind reads; a DC refinement reads none
    for (unsigned i = 0; i < ns; i++) {
      if (kind == kSequential || kind == kDcFirst) {
        sc[i].dc.build(huff_table(false, int(selector[i] >> 4)), true);
      }
      if (kind == kSequential || kind == kAcFirst || kind == kAcRefine) {
        sc[i].ac.build(huff_table(true, int(selector[i] & 15)), false);
      }
    }
    if (ns > 1) {
      int blocks = 0;
      for (unsigned i = 0; i < ns; i++) blocks += sc[i].c->h * sc[i].c->v;
      if (blocks > 10) bad("JPEG MCU has more than 10 blocks");  // JERR_BAD_MCU_SIZE
    }
    if (!allocated) allocate();
    // latch_quant_tables: a component's table is the one at its first scan
    for (unsigned i = 0; i < ns; i++) {
      Component* c = sc[i].c;
      if (c->scanned) continue;
      if (!quant_defined[c->tq]) bad("JPEG component uses a quantization table no DQT defines");
      std::memcpy(c->quant, quant[c->tq], sizeof c->quant);
      c->scanned = true;
    }
    any_scan = true;

    int mcu_w, mcu_h;
    if (ns == 1) {
      mcu_w = (sc[0].c->w + 7) / 8;
      mcu_h = (sc[0].c->ht + 7) / 8;
    } else {
      mcu_w = mcux;
      mcu_h = mcuy;
    }
    BitReader br(d, n, pos);
    int left = restart_interval, next_rst = 0;
    eobrun = 0;
    for (int my = 0; my < mcu_h; my++) {
      for (int mx = 0; mx < mcu_w; mx++) {
        if (restart_interval) {
          if (left == 0) {
            if (eobrun) bad("JPEG end-of-band run runs past its restart interval");
            pos = br.resume();
            if (next_marker() != 0xD0u + unsigned(next_rst)) bad("JPEG restart marker missing");
            next_rst = (next_rst + 1) & 7;
            for (unsigned i = 0; i < ns; i++) sc[i].pred = 0;
            br = BitReader(d, n, pos);
            left = restart_interval;
          }
          left--;
        }
        if (ns == 1) {
          Component* c = sc[0].c;
          scan_block(br, sc[0], &c->coef.p[(size_t(my) * c->bw + mx) * 64]);
        } else {
          for (unsigned i = 0; i < ns; i++) {
            Component* c = sc[i].c;
            for (int y = 0; y < c->v; y++) {
              for (int x = 0; x < c->h; x++) {
                size_t b = size_t(my * c->v + y) * c->bw + size_t(mx * c->h + x);
                scan_block(br, sc[i], &c->coef.p[b * 64]);
              }
            }
          }
        }
      }
    }
    if (eobrun) bad("JPEG end-of-band run runs past the end of its scan");
    pos = br.resume();
  }

  // jidctint.c's jpeg_idct_islow of one block into 8 rows of out.
  // Returns false where a value leaves the range that 8-bit data keeps
  // it in (only corrupt data does): a dequantized coefficient or a
  // first-pass value beyond 16 bits, or an output beyond +-512, where
  // this C arithmetic wraps and libjpeg-turbo's SIMD builds saturate, so
  // their pixels differ.
  static bool idct(const int16_t* in, const int* q, uint8_t* out, size_t stride) {
    const uint8_t* limit = tables().idct_limit;
    int ws[64];
    bool wide = false;
    auto int16 = [&](int64_t v) {
      wide |= v < -32768 || v > 32767;
      return int(v);
    };
    auto sample = [&](int64_t v) {
      wide |= v < -512 || v > 511;
      return limit[int(v) & 1023];
    };
    for (int i = 0; i < 64; i++) int16(int64_t(in[i]) * q[i]);
    for (int col = 0; col < 8; col++) {
      const int16_t* ip = in + col;
      const int* qp = q + col;
      int* wp = ws + col;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int dcval = int16(int64_t(ip[0]) * qp[0] * (1 << kPass1Bits));
        for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
      int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
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
      wp[0] = int16(descale(tmp10 + tmp3, sh));
      wp[56] = int16(descale(tmp10 - tmp3, sh));
      wp[8] = int16(descale(tmp11 + tmp2, sh));
      wp[48] = int16(descale(tmp11 - tmp2, sh));
      wp[16] = int16(descale(tmp12 + tmp1, sh));
      wp[40] = int16(descale(tmp12 - tmp1, sh));
      wp[24] = int16(descale(tmp13 + tmp0, sh));
      wp[32] = int16(descale(tmp13 - tmp0, sh));
    }
    const int sh = kConstBits + kPass1Bits + 3;
    for (int row = 0; row < 8; row++) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + row * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        uint8_t v = sample(descale(wp[0], kPass1Bits + 3));
        for (int i = 0; i < 8; i++) op[i] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConstBits);
      int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConstBits);
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
      op[0] = sample(descale(tmp10 + tmp3, sh));
      op[7] = sample(descale(tmp10 - tmp3, sh));
      op[1] = sample(descale(tmp11 + tmp2, sh));
      op[6] = sample(descale(tmp11 - tmp2, sh));
      op[2] = sample(descale(tmp12 + tmp1, sh));
      op[5] = sample(descale(tmp12 - tmp1, sh));
      op[3] = sample(descale(tmp13 + tmp0, sh));
      op[4] = sample(descale(tmp13 - tmp0, sh));
    }
    return !wide;
  }

  // jdcoefct.c's smoothing_ok: a progressive file whose every component
  // has its table latched, nonzero at the ten positions smoothing reads,
  // and a DC scan; smoothing is useful where any of zigzag 1-9 is not
  // known to its last bit (coefficients past 9 play no part)
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (int i = 0; i < nc; i++) {
      const Component& c = comp[i];
      for (int k = 0; k < kSmoothed; k++) {
        if (uint16_t(c.quant[kNatural[k]]) == 0) return false;
      }
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < kSmoothed; k++) useful |= c.coef_bits[k] != 0;
    }
    return useful;
  }

  // the rounded quotient of num by 256 q with the sign taken apart,
  // capped below 1 << al where al > 0 (the bits still to come)
  static int predict(int64_t num, int64_t q, int al) {
    int64_t p = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
    if (al > 0 && p >= (int64_t(1) << al)) p = (int64_t(1) << al) - 1;
    return int(num >= 0 ? p : -p);
  }

  // jdcoefct.c's decompress_smooth_data on one block: blk's zigzag 1-9
  // that are still zero and not known to their last bit become
  // estimates from the 5x5 neighbourhood dc[25] of DC values (row-major,
  // the block at 12); with no AC coded at all ("change DC"), the DC too
  static void smooth_block(int16_t* blk, const int* dc, const int* quant, const int* bits) {
    bool change_dc = true;
    for (int k = 1; k < kSmoothed; k++) change_dc &= bits[k] == -1;
    // the file's unsigned quantval, which quant holds as int16_t
    const int64_t q00 = uint16_t(quant[0]);
    int ks = change_dc ? kSmoothed : 6;
    for (int k = 1; k < ks; k++) {
      int pos = kNatural[k];
      if (bits[k] == 0 || blk[pos] != 0) continue;
      const int8_t* w = kSmoothKernel[change_dc][k];
      int64_t sum = 0;
      for (int j = 0; j < 25; j++) sum += int64_t(w[j]) * dc[j];
      blk[pos] = int16_t(predict(q00 * sum, uint16_t(quant[pos]), bits[k]));
    }
    if (change_dc) {
      int64_t sum = 0;
      for (int j = 0; j < 25; j++) sum += int64_t(kSmoothDc[j]) * dc[j];
      blk[0] = int16_t(predict(q00 * sum, q00, 0));
    }
  }

  void idct_component(Component& c, bool smooth) {
    size_t stride = size_t(c.bw) * 8;
    c.plane.assign(stride * size_t(c.bh) * 8, 0);
    int rbw = (c.w + 7) / 8, rbh = (c.ht + 7) / 8;
    int16_t ws[64];
    int dc[25];
    for (int by = 0; by < rbh; by++) {
      int rows[5];
      if (smooth) smooth_rows(c, by, rbh, rows);
      for (int bx = 0; bx < rbw; bx++) {
        const int16_t* blk = &c.coef.p[(size_t(by) * c.bw + bx) * 64];
        if (smooth) {
          // the columns two left to two right, replicated at both edges
          for (int j = 0; j < 5; j++) {
            int x = bx + j - 2;
            x = x < 0 ? 0 : x >= rbw ? rbw - 1 : x;
            for (int i = 0; i < 5; i++) dc[5 * i + j] = c.coef.p[(size_t(rows[i]) * c.bw + x) * 64];
          }
          std::memcpy(ws, blk, sizeof ws);
          smooth_block(ws, dc, c.quant, c.coef_bits);
          blk = ws;
        }
        if (!idct(blk, c.quant, &c.plane[size_t(by) * 8 * stride + size_t(bx) * 8], stride)) {
          bad("JPEG coefficients beyond the range of 8-bit samples");
        }
      }
    }
    c.coef.release();
  }

  // the block rows decompress_smooth_data reads for block row by (two
  // above to two below).  It counts rows within the iMCU row's block
  // rows (the component's v, or fewer in the last iMCU row), so where
  // the last iMCU row holds fewer than v block rows its edge tests fall
  // short of the real ones: they may read the dummy rows of the buffer
  // below the image, or repeat a row above.
  void smooth_rows(const Component& c, int by, int rbh, int* rows) const {
    int imcu = by / c.v, block_row = by % c.v;
    int block_rows = c.v;
    if (imcu == mcuy - 1 && rbh % c.v) block_rows = rbh % c.v;
    int row = imcu * block_rows + block_row, nrows = block_rows * mcuy;
    rows[2] = by;
    rows[1] = row > 0 ? by - 1 : by;
    rows[0] = row > 1 ? by - 2 : rows[1];
    rows[3] = row < nrows - 1 ? by + 1 : by;
    rows[4] = row < nrows - 2 ? by + 2 : rows[3];
  }

  // jdsample.c's h2v1_fancy_upsample of one row of cw samples (cw > 2)
  static void fancy_h2(const uint8_t* in, int cw, uint8_t* out) {
    out[0] = in[0];
    out[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < cw - 1; i++) {
      int v = in[i] * 3;
      out[2 * i] = uint8_t((v + in[i - 1] + 1) >> 2);
      out[2 * i + 1] = uint8_t((v + in[i + 1] + 2) >> 2);
    }
    out[2 * cw - 2] = uint8_t((in[cw - 1] * 3 + in[cw - 2] + 1) >> 2);
    out[2 * cw - 1] = in[cw - 1];
  }

  // jdsample.c's h2v2_fancy_upsample of one output row: near is the
  // nearest chroma row, far the next nearest (cw > 2)
  static void fancy_h2v2(const uint8_t* near, const uint8_t* far, int cw, uint8_t* out) {
    int this_s = near[0] * 3 + far[0];
    int next_s = near[1] * 3 + far[1];
    out[0] = uint8_t((this_s * 4 + 8) >> 4);
    out[1] = uint8_t((this_s * 3 + next_s + 7) >> 4);
    int last_s = this_s;
    this_s = next_s;
    for (int i = 1; i < cw - 1; i++) {
      next_s = near[i + 1] * 3 + far[i + 1];
      out[2 * i] = uint8_t((this_s * 3 + last_s + 8) >> 4);
      out[2 * i + 1] = uint8_t((this_s * 3 + next_s + 7) >> 4);
      last_s = this_s;
      this_s = next_s;
    }
    out[2 * cw - 2] = uint8_t((this_s * 3 + last_s + 8) >> 4);
    out[2 * cw - 1] = uint8_t((this_s * 4 + 7) >> 4);
  }

  // jdsample.c's h1v2_fancy_upsample of one output row: the nearest
  // row weighs 3, the next nearest (above for an even row, with bias 1;
  // below for an odd row, bias 2) 1
  static void fancy_h1v2(const uint8_t* near, const uint8_t* far, int bias, int cw,
                         uint8_t* out) {
    for (int x = 0; x < cw; x++) out[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
  }

  // row y of component c at full size, by the method jinit_upsampler
  // picks for its ratio to the largest factors: the plane's own row, or
  // out filled.  Rows past the component's last repeat it, as libjpeg's
  // context rows do.
  const uint8_t* upsampled_row(const Component& c, int y, uint8_t* out) const {
    size_t stride = size_t(c.bw) * 8;
    const uint8_t* p = c.plane.data();
    int cw = c.w;
    if (c.hr == 1 && c.vr == 1) return p + size_t(y) * stride;  // fullsize_upsample
    if (c.hr == 2 && c.vr == 1 && cw > 2) {
      fancy_h2(p + size_t(y) * stride, cw, out);
    } else if (c.hr == 1 && c.vr == 2) {
      int cy = y >> 1;
      if (y & 1) {
        fancy_h1v2(p + size_t(cy) * stride, p + size_t(cy + 1 < c.ht ? cy + 1 : cy) * stride, 2,
                   cw, out);
      } else {
        fancy_h1v2(p + size_t(cy) * stride, p + size_t(cy > 0 ? cy - 1 : 0) * stride, 1, cw, out);
      }
    } else if (c.hr == 2 && c.vr == 2 && cw > 2) {
      int cy = y >> 1;
      int fy = (y & 1) ? (cy + 1 < c.ht ? cy + 1 : cy) : (cy > 0 ? cy - 1 : 0);
      fancy_h2v2(p + size_t(cy) * stride, p + size_t(fy) * stride, cw, out);
    } else {
      // int_upsample (and h2v1_upsample / h2v2_upsample for rows of 2
      // samples or less): each sample repeated hr x vr times
      const uint8_t* row = p + size_t(y / c.vr) * stride;
      for (int x = 0; x < W; x++) out[x] = row[x / c.hr];
    }
    return out;
  }

  void output(uint8_t* out) {
    if (int64_t(H) * W * nc != out_len) bad("output buffer has the wrong size");
    for (int i = 0; i < nc; i++) {
      if (!comp[i].scanned) bad("JPEG component never coded in a scan");
    }
    bool smooth = smoothing_ok();
    for (int i = 0; i < nc; i++) idct_component(comp[i], smooth);
    if (nc == 1) {
      const Component& c = comp[0];
      size_t stride = size_t(c.bw) * 8;
      for (int y = 0; y < H; y++) std::memcpy(out + size_t(y) * W, &c.plane[y * stride], size_t(W));
      return;
    }
    // jdmaster.c's default_decompress_parms: JFIF or Adobe transform 1
    // means YCbCr, Adobe transform 0 or component ids 'R','G','B' RGB
    bool rgb = false;
    if (!jfif) {
      if (adobe) {
        rgb = adobe_transform == 0;
      } else {
        rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
      }
    }
    const Tables& t = tables();
    std::vector<uint8_t> buf[3];
    for (auto& b : buf) b.resize(size_t(W) + 16);
    for (int y = 0; y < H; y++) {
      const uint8_t* yr = upsampled_row(comp[0], y, buf[0].data());
      const uint8_t* cb = upsampled_row(comp[1], y, buf[1].data());
      const uint8_t* cr = upsampled_row(comp[2], y, buf[2].data());
      uint8_t* o = out + size_t(y) * W * 3;
      if (rgb) {
        for (int x = 0; x < W; x++) {
          o[3 * x] = yr[x];
          o[3 * x + 1] = cb[x];
          o[3 * x + 2] = cr[x];
        }
        continue;
      }
      for (int x = 0; x < W; x++) {
        int yy = yr[x], b = cb[x], r = cr[x];
        o[3 * x] = clamp255(yy + t.cr_r[r]);
        o[3 * x + 1] = clamp255(yy + int((t.cb_g[b] + t.cr_g[r]) >> kScaleBits));
        o[3 * x + 2] = clamp255(yy + t.cb_b[b]);
      }
    }
  }

  // markers up to the frame header (probe) or to EOI (decode)
  void run(bool header_only, uint8_t* out) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) bad("not a JPEG file (no SOI marker)");
    for (;;) {
      unsigned m = next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        if (have_frame) bad("JPEG has a second SOF");
        progressive = m == 0xC2;
        read_sof();
        if (header_only) return;
      } else if ((m >= 0xC3 && m <= 0xCB && m != 0xC4 && m != 0xC8) || (m >= 0xCD && m <= 0xCF)) {
        not_mine("JPEG is not sequential or progressive Huffman");
      } else if (m == 0xCC) {
        not_mine("JPEG uses arithmetic coding");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        size_t end;
        segment(&end);
        if (end - pos != 2) bad("JPEG DRI segment has the wrong length");
        restart_interval = int(u16());
      } else if (m == 0xDA) {
        read_sos();
      } else if (m == 0xD9) {
        if (!have_frame) bad("JPEG ends before its SOF");
        if (!any_scan) bad("JPEG has no SOS");
        output(out);
        return;
      } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
        read_app(m);
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // RSTn and TEM outside a scan carry no data; libjpeg skips them
      } else if (m == 0xD8) {
        bad("JPEG has a second SOI");
      } else {
        bad("JPEG has an unknown marker");
      }
    }
  }
};

// ---------------------------------------------------------------------
// encoding

struct HuffEncoder {
  uint32_t code[256];
  uint8_t size[256];
  // jpeg_make_c_derived_tbl
  HuffEncoder(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof size);
    std::memset(code, 0, sizeof code);
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l - 1]; i++, p++) {
        code[vals[p]] = c++;
        size[vals[p]] = uint8_t(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((uint32_t(1) << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = uint8_t(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
    acc &= (uint64_t(1) << nbits) - 1;
  }
  void flush() {  // pad the last byte with ones
    if (nbits) put(0x7F, 8 - nbits);
  }
};

// jcdctmgr.c's compute_reciprocal for 16-bit DCT elements
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(unsigned divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 0;
  while ((divisor >> (b + 1)) != 0) b++;
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

// jfdctint.c's jpeg_fdct_islow in place, then the quantizer
void fdct_quantize(int* data, const Divisor* div, int16_t* coef) {
  for (int pass = 0; pass < 2; pass++) {
    int step = pass ? 1 : 8, elem = pass ? 8 : 1;
    for (int k = 0; k < 8; k++) {
      int* p = data + k * step;
      int64_t tmp0 = p[0] + p[7 * elem], tmp7 = p[0] - p[7 * elem];
      int64_t tmp1 = p[elem] + p[6 * elem], tmp6 = p[elem] - p[6 * elem];
      int64_t tmp2 = p[2 * elem] + p[5 * elem], tmp5 = p[2 * elem] - p[5 * elem];
      int64_t tmp3 = p[3 * elem] + p[4 * elem], tmp4 = p[3 * elem] - p[4 * elem];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int odd_shift = pass ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
      if (pass) {
        p[0] = int(descale(tmp10 + tmp11, kPass1Bits));
        p[4 * elem] = int(descale(tmp10 - tmp11, kPass1Bits));
      } else {
        p[0] = int((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4 * elem] = int((tmp10 - tmp11) * (1 << kPass1Bits));
      }
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * elem] = int(descale(z1 + tmp13 * FIX_0_765366865, odd_shift));
      p[6 * elem] = int(descale(z1 + tmp12 * -FIX_1_847759065, odd_shift));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * elem] = int(descale(tmp4 + z1 + z3, odd_shift));
      p[5 * elem] = int(descale(tmp5 + z2 + z4, odd_shift));
      p[3 * elem] = int(descale(tmp6 + z2 + z3, odd_shift));
      p[elem] = int(descale(tmp7 + z1 + z4, odd_shift));
    }
  }
  for (int i = 0; i < 64; i++) {
    int t = data[i];
    const Divisor& dv = div[i];
    bool neg = t < 0;
    uint32_t a = uint32_t(neg ? -t : t);
    uint32_t prod = (a + dv.corr) * dv.recip;
    int v = int(prod >> dv.shift);
    coef[i] = int16_t(neg ? -v : v);
  }
}

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc, const HuffEncoder& dc,
                  const HuffEncoder& ac) {
  int temp = blk[0] - last_dc, temp2 = temp;
  last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  // libjpeg's JERR_BAD_DCT_COEF: 8-bit data has at most 11-bit DC
  // differences and 10-bit AC coefficients
  if (nbits > 11) bad("JPEG DC difference out of range");
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put(uint32_t(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while (temp >>= 1) nbits++;
    if (nbits > 10) bad("JPEG AC coefficient out of range");
    int sym = (r << 4) + nbits;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(uint32_t(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, unsigned v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 0xFF));
}

// a padded plane: rows and columns past the image repeat the last one
struct Plane {
  int w, h;  // padded size
  std::vector<uint8_t> px;
  const uint8_t* block(int by, int bx) const { return &px[size_t(by) * 8 * w + size_t(bx) * 8]; }
};

void encode(const uint8_t* pix, int H, int W, int nc, int quality, std::vector<uint8_t>& o) {
  const Tables& t = tables();
  // jpeg_quality_scaling and jpeg_add_quant_table with force_baseline
  int q = quality < 1 ? 1 : quality > 100 ? 100 : quality;
  int scale = q < 50 ? 5000 / q : 200 - q * 2;
  int qt[2][64];
  for (int k = 0; k < 2; k++) {
    const int* base = k ? kStdChrQ : kStdLumQ;
    for (int i = 0; i < 64; i++) {
      long v = (long(base[i]) * scale + 50) / 100;
      qt[k][i] = int(v <= 0 ? 1 : v > 255 ? 255 : v);
    }
  }
  Divisor div[2][64];
  for (int k = 0; k < 2; k++) {
    for (int i = 0; i < 64; i++) div[k][i] = reciprocal(unsigned(qt[k][i]) << 3);
  }

  // headers: SOI, JFIF APP0, DQT(s), SOF0, DHTs, SOS
  const uint8_t jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), jfif, jfif + sizeof jfif);
  int ntab = nc == 3 ? 2 : 1;
  for (int k = 0; k < ntab; k++) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(uint8_t(k));
    for (int i = 0; i < 64; i++) o.push_back(uint8_t(qt[k][kNatural[i]]));
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, unsigned(8 + 3 * nc));
  o.push_back(8);
  put16(o, unsigned(H));
  put16(o, unsigned(W));
  o.push_back(uint8_t(nc));
  for (int c = 0; c < nc; c++) {
    o.push_back(uint8_t(c + 1));
    o.push_back(nc == 3 && c == 0 ? 0x22 : 0x11);
    o.push_back(c ? 1 : 0);
  }
  const uint8_t* bits[4] = {kDcLumBits, kAcLumBits, kDcChrBits, kAcChrBits};
  const uint8_t* vals[4] = {kDcVals, kAcLumVals, kDcVals, kAcChrVals};
  for (int k = 0; k < 2 * ntab; k++) {
    int count = 0;
    for (int l = 0; l < 16; l++) count += bits[k][l];
    o.push_back(0xFF);
    o.push_back(0xC4);
    put16(o, unsigned(2 + 1 + 16 + count));
    o.push_back(uint8_t(((k & 1) << 4) | (k >> 1)));
    o.insert(o.end(), bits[k], bits[k] + 16);
    o.insert(o.end(), vals[k], vals[k] + count);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, unsigned(6 + 2 * nc));
  o.push_back(uint8_t(nc));
  for (int c = 0; c < nc; c++) {
    o.push_back(uint8_t(c + 1));
    o.push_back(c ? 0x11 : 0x00);
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  HuffEncoder dc0(kDcLumBits, kDcVals), ac0(kAcLumBits, kAcLumVals);
  HuffEncoder dc1(kDcChrBits, kDcVals), ac1(kAcChrBits, kAcChrVals);
  BitWriter bw(o);
  int block[64];
  int16_t coef[64];
  auto fdct = [&](const Plane& p, int by, int bx, int k, int16_t* out) {
    const uint8_t* s = p.block(by, bx);
    for (int r = 0; r < 8; r++) {
      for (int c = 0; c < 8; c++) block[8 * r + c] = int(s[size_t(r) * p.w + c]) - 128;
    }
    fdct_quantize(block, div[k], out);
  };

  if (nc == 1) {
    // one component, one block an MCU, blocks over ceil(W/8) x ceil(H/8)
    int bwid = (W + 7) / 8, bhgt = (H + 7) / 8;
    Plane p{bwid * 8, bhgt * 8, {}};
    p.px.resize(size_t(p.w) * p.h);
    for (int y = 0; y < p.h; y++) {
      const uint8_t* src = pix + size_t(y < H ? y : H - 1) * W;
      uint8_t* dst = &p.px[size_t(y) * p.w];
      std::memcpy(dst, src, size_t(W));
      std::memset(dst + W, src[W - 1], size_t(p.w - W));
    }
    int last = 0;
    for (int by = 0; by < bhgt; by++) {
      for (int bx = 0; bx < bwid; bx++) {
        fdct(p, by, bx, 0, coef);
        encode_block(bw, coef, last, dc0, ac0);
      }
    }
  } else {
    // YCbCr at full size, the edges repeated to whole 16x16 MCUs
    int mx = (W + 15) / 16, my = (H + 15) / 16;
    int pw = mx * 16, ph = my * 16;
    Plane yp{pw, ph, {}}, full[2] = {{pw, ph, {}}, {pw, ph, {}}};
    yp.px.resize(size_t(pw) * ph);
    full[0].px.resize(size_t(pw) * ph);
    full[1].px.resize(size_t(pw) * ph);
    for (int y = 0; y < H; y++) {
      const uint8_t* src = pix + size_t(y) * W * 3;
      size_t row = size_t(y) * pw;
      for (int x = 0; x < W; x++) {
        int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
        yp.px[row + x] = uint8_t((t.ycc[0][r] + t.ycc[1][g] + t.ycc[2][b]) >> kScaleBits);
        full[0].px[row + x] = uint8_t((t.ycc[3][r] + t.ycc[4][g] + t.ycc[5][b]) >> kScaleBits);
        full[1].px[row + x] = uint8_t((t.ycc[5][r] + t.ycc[6][g] + t.ycc[7][b]) >> kScaleBits);
      }
      for (Plane* p : {&yp, &full[0], &full[1]}) {
        std::memset(&p->px[row + W], p->px[row + W - 1], size_t(pw - W));
      }
    }
    for (int y = H; y < ph; y++) {
      for (Plane* p : {&yp, &full[0], &full[1]}) {
        std::memcpy(&p->px[size_t(y) * pw], &p->px[size_t(H - 1) * pw], size_t(pw));
      }
    }
    // jcsample.c's h2v2_downsample over rows 0..ceil(H/2)-1, later rows
    // repeating the last of them
    int cw = pw / 2, ch = ph / 2, creal = (H + 1) / 2;
    Plane cp[2] = {{cw, ch, {}}, {cw, ch, {}}};
    for (int k = 0; k < 2; k++) {
      cp[k].px.resize(size_t(cw) * ch);
      for (int y = 0; y < ch; y++) {
        uint8_t* dst = &cp[k].px[size_t(y) * cw];
        if (y >= creal) {
          std::memcpy(dst, &cp[k].px[size_t(creal - 1) * cw], size_t(cw));
          continue;
        }
        const uint8_t* a = &full[k].px[size_t(2 * y) * pw];
        const uint8_t* b = a + pw;
        int bias = 1;
        for (int x = 0; x < cw; x++) {
          dst[x] = uint8_t((a[2 * x] + a[2 * x + 1] + b[2 * x] + b[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
    // luma blocks past ceil(W/8) x ceil(H/8) are dummies: no AC, the DC
    // of the block before them (jccoefct.c's compress_data)
    int lbw = (W + 7) / 8, lbh = (H + 7) / 8;
    int lastc[3] = {0, 0, 0};
    int16_t mcu[4][64];
    for (int j = 0; j < my; j++) {
      for (int i = 0; i < mx; i++) {
        for (int yy = 0; yy < 2; yy++) {
          int by = 2 * j + yy;
          for (int xx = 0; xx < 2; xx++) {
            int bx = 2 * i + xx;
            int16_t* blk = mcu[2 * yy + xx];
            if (by < lbh && bx < lbw) {
              fdct(yp, by, bx, 0, blk);
            } else {
              std::memset(blk, 0, sizeof mcu[0]);
              // below the image: the DC of the row above's last block
              blk[0] = by < lbh ? mcu[2 * yy + xx - 1][0] : mcu[1][0];
            }
          }
        }
        for (int b = 0; b < 4; b++) encode_block(bw, mcu[b], lastc[0], dc0, ac0);
        for (int k = 0; k < 2; k++) {
          fdct(cp[k], j, i, 1, coef);
          encode_block(bw, coef, lastc[1 + k], dc1, ac1);
        }
      }
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
}

void set_error(char* err, int64_t errlen, const std::string& msg) {
  if (err && errlen > 0) {
    size_t k = msg.size() < size_t(errlen - 1) ? msg.size() : size_t(errlen - 1);
    std::memcpy(err, msg.data(), k);
    err[k] = 0;
  }
}

}  // namespace

extern "C" {

// 0: a file the decoder reads, dims = {height, width, channels};
// 1: a JPEG it leaves to another decoder; -1: malformed (err says why)
int jpeg_probe(const uint8_t* data, int64_t n, int32_t* dims, char* err, int64_t errlen) {
  try {
    Decoder dec(data, size_t(n));
    dec.run(true, nullptr);
    if (!dec.have_frame) bad("JPEG has no SOF");
    dims[0] = dec.H;
    dims[1] = dec.W;
    dims[2] = dec.nc;
    return 0;
  } catch (const NotMine& e) {
    set_error(err, errlen, e.msg);
    return 1;
  } catch (const Malformed& e) {
    set_error(err, errlen, e.msg);
    return -1;
  }
}

// decode into out (height * width * channels bytes, as jpeg_probe gave)
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_len, char* err,
                int64_t errlen) {
  try {
    Decoder dec(data, size_t(n));
    dec.out_len = out_len;
    dec.run(false, out);
    return 0;
  } catch (const NotMine& e) {
    set_error(err, errlen, e.msg);
    return 1;
  } catch (const Malformed& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory decoding the JPEG");
    return -1;
  }
}

// encode height x width x channels (1 or 3) uint8 pixels; *out is
// allocated here and released with jpeg_free
int jpeg_encode(const uint8_t* pix, int32_t h, int32_t w, int32_t c, int32_t quality,
                uint8_t** out, int64_t* out_len, char* err, int64_t errlen) {
  try {
    if (h < 1 || w < 1 || h > 65535 || w > 65535 || (c != 1 && c != 3)) {
      bad("JPEG writer takes 1 to 65535 rows and columns of 1 or 3 channels");
    }
    std::vector<uint8_t> o;
    o.reserve(size_t(h) * w * c / 4 + 1024);
    encode(pix, h, w, c, quality, o);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(o.size()));
    if (!buf) throw std::bad_alloc();
    std::memcpy(buf, o.data(), o.size());
    *out = buf;
    *out_len = int64_t(o.size());
    return 0;
  } catch (const Malformed& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory encoding the JPEG");
    return -1;
  }
}

void jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
