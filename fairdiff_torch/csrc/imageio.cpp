// Host image codec and threaded batch loader: the counterpart of the JAX
// package's native loader (fairdiff/native/imageloader.cpp), without libjpeg,
// libpng or zlib. C++17 and its standard library only.
//
// - inflate (RFC 1950/1951: stored, fixed and dynamic blocks, Adler-32);
// - PNG decode: colour types 0, 2, 3, 4, 6, bit depths 1-16, the five
//   filters, Adam7, tRNS, in two conventions:
//     kPil:    what PIL's `Image.open(p).convert("RGB")` gives (alpha dropped,
//              16-bit samples cut to their high byte, 16-bit grey clipped);
//     kNative: what libpng 1.6's simplified API gives for PNG_FORMAT_RGB
//              with a null background onto a zeroed buffer (alpha composited
//              onto black in linear light, 16-bit samples taken as linear),
//              with libpng's rules for gAMA, sRGB, cHRM, iCCP, sBIT and tRNS
//              and its chunk order and CRC handling (IHDR once and first
//              among the chunks it knows, an ancillary chunk with a bad CRC
//              dropped, nothing after the image data read), a palette cut
//              to 2^depth entries, and the end of the image data's zlib
//              stream read as libpng reads it (see Inflater); kPil reads
//              that end as PIL does, and fails on an iCCP chunk of another
//              compression method than 0, as PIL does;
// - JPEG decode: baseline, extended and progressive Huffman, 8-bit, 1 or 3
//   components, sampling factors 1-2, restart intervals, JFIF and Adobe
//   markers. Equal to libjpeg(-turbo)'s default output: the accurate integer
//   IDCT (jidctint), "fancy" triangular upsampling and the fixed-point
//   YCbCr -> RGB tables;
// - JPEG encode: baseline 4:2:0 with PIL's `save(path, quality=q)` defaults
//   (libjpeg's quality scaling of the standard tables, h2v2 downsampling,
//   the standard Huffman tables, jfdctint, a JFIF APP0 marker);
// - fdio_load_batch: the native loader's decode + bilinear warp or resize +
//   (u8 - 127.5) / 127.5 + flip, one status per item, on a thread pool.
//
// Every entry point reports failure by status, never by exception:
//   0 ok, 1 unreadable, 2 singular affine, 3 not a PNG or JPEG,
//   4 corrupt or truncated, 5 a feature the decoder does not implement.
//
// Build: c++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off
// (fairdiff_torch/kernels/build.py); binding: fairdiff_torch/io/imageio.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Status { kOk = 0, kUnreadable = 1, kSingular = 2, kNotImage = 3, kCorrupt = 4, kUnsupported = 5 };
enum Convention { kPil = 0, kNative = 1 };

struct Fail {
  int status;
};
[[noreturn]] void fail(int status) { throw Fail{status}; }

struct Image {
  std::vector<uint8_t> rgb;  // h * w * 3
  int h = 0, w = 0;
};

// ---------------------------------------------------------------- inflate

struct InflateHuff {
  uint16_t count[16];
  uint16_t symbol[320];
  uint16_t fast[1 << 9];  // (length << 9) | symbol for codes of <= 9 bits, else 0
};

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  for (size_t i = 0; i < n;) {
    size_t end = std::min(n, i + 5552);
    for (; i < end; ++i) {
      a += p[i];
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

// How much of a zlib stream a reader holds to, beyond the `expect` bytes it
// wants:
//   kPrefix: nothing (libpng's iCCP: the profile's bytes, whatever follows);
//   kReadPil, kReadLibpng: as a reader of image data that stops at the image's last
//     byte. It feeds the stream in windows (`windows`: the end offset of
//     each, ascending; PIL takes each IDAT chunk in pieces of 65536 bytes,
//     libpng in pieces of PNG_IDAT_READ_SIZE, 8192), one row at a time. The
//     call that produces the image's last byte goes on within its window
//     until the stream needs output or input: an error met there, a bad
//     Adler-32 included, fails the read, and a stream that ends there is
//     whole. Beyond that window PIL reads no more; libpng reads on
//     (png_read_finish_IDAT): an error it meets is benign, but a stream that
//     needs more data than the IDAT chunks hold fails ("Not enough image
//     data").
enum StreamEnd { kPrefix, kReadPil, kReadLibpng };

class Inflater {
 public:
  Inflater(const uint8_t* data, size_t n, size_t expect, StreamEnd end,
           const std::vector<size_t>* windows = nullptr)
      : d_(data), n_(n), expect_(expect), end_(end), windows_(windows) {
    out_.reserve(expect);
  }

  // the stream inflated: at least `expect` bytes
  std::vector<uint8_t> run() {
    bool failed = false;
    try {
      inflate_all();
    } catch (const Fail&) {
      failed = true;
    }
    if (fill_bit_ < 0) fail(kCorrupt);  // the wanted bytes never came
    if (end_ == kPrefix) return std::move(out_);
    const int64_t stop = consumed();     // where the stream failed or ended
    const size_t last = size_t((fill_bit_ + 7) / 8) - 1;  // the byte that completed them
    const size_t window_end = *std::upper_bound(windows_->begin(), windows_->end(), last);
    const bool in_call = more_bit_ < 0 && !starved_ && stop <= int64_t(window_end) * 8;
    if (failed && (in_call || (end_ == kReadLibpng && starved_))) fail(kCorrupt);
    return std::move(out_);
  }

 private:
  int64_t consumed() const { return int64_t(pos_) * 8 - cnt_; }
  // the output reached the image's bytes (once), and whether the symbol that
  // got there has more to write
  void filled() {
    if (fill_bit_ < 0 && out_.size() >= expect_) {
      fill_bit_ = consumed();
      if (out_.size() > expect_) more_bit_ = fill_bit_;
    }
  }
  // a symbol after the image's bytes writes output: the reader's call stops here
  void needs_output() {
    if (fill_bit_ >= 0 && more_bit_ < 0) more_bit_ = consumed();
  }

  void inflate_all() {
    if (n_ < 2) starve();
    int cmf = d_[0], flg = d_[1];
    if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 != 0 || (flg & 0x20)) fail(kCorrupt);
    pos_ = 2;
    int last;
    do {
      last = bits(1);
      int type = bits(2);
      if (type == 0) {
        stored();
      } else if (type == 1) {
        static const FixedTables fixed;
        codes(fixed.lit, fixed.dist);
      } else if (type == 2) {
        dynamic();
      } else {
        fail(kCorrupt);
      }
    } while (!last);
    // Adler-32 of the output, big-endian, after the last block's byte
    buf_ >>= cnt_ % 8;
    cnt_ -= cnt_ % 8;
    uint32_t want = 0;
    for (int i = 0; i < 4; ++i) want = (want << 8) | uint32_t(bits(8));
    if (adler32(out_.data(), out_.size()) != want) fail(kCorrupt);
  }

 public:
  static void build(InflateHuff* h, const uint8_t* lengths, int n) {
    std::memset(h, 0, sizeof(*h));
    for (int s = 0; s < n; ++s) h->count[lengths[s]]++;
    h->count[0] = 0;
    int left = 1;
    for (int len = 1; len < 16; ++len) {
      left = (left << 1) - h->count[len];
      if (left < 0) fail(kCorrupt);  // over-subscribed
    }
    uint16_t offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + h->count[len];
    for (int s = 0; s < n; ++s)
      if (lengths[s]) h->symbol[offs[lengths[s]]++] = uint16_t(s);
    // the 9-bit table: canonical codes, bit-reversed (deflate packs codes MSB first)
    int code = 0, index = 0;
    for (int len = 1; len <= 9; ++len) {
      for (int k = 0; k < h->count[len]; ++k, ++code, ++index) {
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int fill = rev; fill < (1 << 9); fill += 1 << len)
          h->fast[fill] = uint16_t((len << 9) | h->symbol[index]);
      }
      code <<= 1;
    }
  }

 private:
  [[noreturn]] void starve() {  // the stream needs more data than there is
    starved_ = true;
    fail(kCorrupt);
  }
  struct FixedTables {
    InflateHuff lit, dist;
    FixedTables() {
      uint8_t l[288];
      for (int s = 0; s < 144; ++s) l[s] = 8;
      for (int s = 144; s < 256; ++s) l[s] = 9;
      for (int s = 256; s < 280; ++s) l[s] = 7;
      for (int s = 280; s < 288; ++s) l[s] = 8;
      build(&lit, l, 288);
      uint8_t d[30];
      for (int s = 0; s < 30; ++s) d[s] = 5;
      build(&dist, d, 30);
    }
  };

  void refill() {
    while (cnt_ <= 56 && pos_ < n_) {
      buf_ |= uint64_t(d_[pos_++]) << cnt_;
      cnt_ += 8;
    }
  }
  int bits(int need) {
    if (cnt_ < need) {
      refill();
      if (cnt_ < need) starve();
    }
    int v = int(buf_ & ((uint64_t(1) << need) - 1));
    buf_ >>= need;
    cnt_ -= need;
    return v;
  }
  int decode(const InflateHuff& h) {
    if (cnt_ < 9) refill();
    uint16_t e = h.fast[buf_ & 511];
    if (e && (e >> 9) <= cnt_) {
      buf_ >>= (e >> 9);
      cnt_ -= (e >> 9);
      return e & 511;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; ++len) {
      code |= bits(1);
      int count = h.count[len];
      if (code - count < first) return h.symbol[index + (code - first)];
      index += count;
      first = (first + count) << 1;
      code <<= 1;
    }
    fail(kCorrupt);
  }
  void stored() {
    buf_ >>= cnt_ % 8;
    cnt_ -= cnt_ % 8;
    int len = bits(16), nlen = bits(16);
    if ((len ^ 0xFFFF) != nlen) fail(kCorrupt);
    if (len) needs_output();
    while (len && cnt_ >= 8) {
      out_.push_back(uint8_t(bits(8)));
      --len;
      filled();
    }
    // the rest straight from the input: the image's last byte, where it is
    // among them, was read at its own offset
    size_t before = out_.size(), take = std::min(size_t(len), n_ - pos_);
    out_.insert(out_.end(), d_ + pos_, d_ + pos_ + take);
    if (fill_bit_ < 0 && out_.size() >= expect_) {
      fill_bit_ = int64_t(pos_ + (expect_ - before) - 1) * 8 + 8;
      if (out_.size() > expect_ || take < size_t(len)) more_bit_ = fill_bit_;
    }
    pos_ += take;
    if (take < size_t(len)) starve();
  }
  void codes(const InflateHuff& lit, const InflateHuff& dist) {
    static const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                          31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                          2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const uint16_t kDistBase[30] = {1,   2,   3,   4,   5,   7,    9,    13,   17,   25,
                                           33,  49,  65,  97,  129, 193,  257,  385,  513,  769,
                                           1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
    static const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                           6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    for (;;) {
      int sym = decode(lit);
      if (sym < 256) {
        needs_output();
        out_.push_back(uint8_t(sym));
        filled();
      } else if (sym == 256) {
        return;
      } else {
        sym -= 257;
        if (sym >= 29) fail(kCorrupt);
        size_t len = kLenBase[sym] + bits(kLenExtra[sym]);
        int ds = decode(dist);
        if (ds >= 30) fail(kCorrupt);
        size_t back = kDistBase[ds] + bits(kDistExtra[ds]);
        needs_output();
        if (back > out_.size()) fail(kCorrupt);
        size_t from = out_.size() - back;
        for (size_t k = 0; k < len; ++k) out_.push_back(out_[from + k]);
        filled();
      }
    }
  }
  void dynamic() {
    static const uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
    int nlen = bits(5) + 257, ndist = bits(5) + 1, ncode = bits(4) + 4;
    if (nlen > 286 || ndist > 30) fail(kCorrupt);
    uint8_t lengths[320] = {0};
    for (int i = 0; i < ncode; ++i) lengths[kOrder[i]] = uint8_t(bits(3));
    InflateHuff lencode;
    build(&lencode, lengths, 19);
    int i = 0;
    while (i < nlen + ndist) {
      int sym = decode(lencode);
      if (sym < 16) {
        lengths[i++] = uint8_t(sym);
        continue;
      }
      int rep, val = 0;
      if (sym == 16) {
        if (i == 0) fail(kCorrupt);
        val = lengths[i - 1];
        rep = 3 + bits(2);
      } else if (sym == 17) {
        rep = 3 + bits(3);
      } else {
        rep = 11 + bits(7);
      }
      if (i + rep > nlen + ndist) fail(kCorrupt);
      while (rep--) lengths[i++] = uint8_t(val);
    }
    if (lengths[256] == 0) fail(kCorrupt);
    InflateHuff lit, dist;
    build(&lit, lengths, nlen);
    build(&dist, lengths + nlen, ndist);
    codes(lit, dist);
  }

  const uint8_t* d_;
  size_t n_, pos_ = 0;
  uint64_t buf_ = 0;
  int cnt_ = 0;
  std::vector<uint8_t> out_;
  size_t expect_;
  StreamEnd end_;
  const std::vector<size_t>* windows_;
  int64_t fill_bit_ = -1;  // bits consumed when the output reached `expect_`
  int64_t more_bit_ = -1;  // ... when a symbol after that first wrote output
  bool starved_ = false;   // the stream ran past the end of the data
};

// -------------------------------------------------------------------- PNG

uint32_t crc32(const uint8_t* p, size_t n) {
  static const auto table = [] {
    std::vector<uint32_t> t(256);
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t be32(const uint8_t* p) { return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3]; }

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

// libpng's gamma arithmetic (pngrtran.c, png.c), with gammas in units of 1e-5
int64_t png_reciprocal(int64_t a) { return int64_t(std::floor(1e10 / double(a) + .5)); }
int64_t png_reciprocal2(int64_t a, int64_t b) { return int64_t(std::floor(1e15 / (double(a) * double(b)) + .5)); }
int64_t png_product2(int64_t a, int64_t b) { return int64_t(std::floor(double(a) * double(b) * 1e-5 + .5)); }
bool gamma_significant(int64_t g) { return g < 100000 - 5000 || g > 100000 + 5000; }

// png_muldiv: a * times / divisor, rounded; false on a zero divisor or a
// result outside 32 bits
bool png_muldiv(int64_t* res, int64_t a, int64_t times, int64_t divisor) {
  if (!divisor) return false;
  if (!a || !times) {
    *res = 0;
    return true;
  }
  double r = std::floor(double(a) * double(times) / double(divisor) + .5);
  if (r > 2147483647. || r < -2147483648.) return false;
  *res = int64_t(r);
  return true;
}

// png_gamma_threshold: whether file -> screen needs a gamma correction at all
bool gamma_threshold(int64_t screen, int64_t file) {
  int64_t g;
  return !png_muldiv(&g, screen, file, 100000) || gamma_significant(g);
}

// The part of libpng's png_colorspace (png.c) that decides the file gamma:
// gAMA, sRGB and cHRM in file order, each able to invalidate the colour
// space, after which no later one changes it; the gamma set so far stays.
struct Xy {
  int64_t v[8];  // white x, y; red x, y; green x, y; blue x, y (the cHRM order)
};
const Xy kSrgbXy = {{31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000}};

bool endpoints_match(const Xy& a, const Xy& b, int64_t delta) {
  for (int i = 0; i < 8; ++i)
    if (a.v[i] < b.v[i] - delta || a.v[i] > b.v[i] + delta) return false;
  return true;
}

// png_colorspace_check_xy: png_XYZ_from_xy, back with png_xy_from_XYZ,
// within 5e-5 of the chunk's values
bool chromaticities_valid(const Xy& c) {
  const int64_t wx = c.v[0], wy = c.v[1], rx = c.v[2], ry = c.v[3], gx = c.v[4], gy = c.v[5], bx = c.v[6],
                by = c.v[7], one = 100000;
  if (rx < 0 || rx > one || ry < 0 || ry > one - rx || gx < 0 || gx > one || gy < 0 || gy > one - gx || bx < 0 ||
      bx > one || by < 0 || by > one - bx || wx < 0 || wx > one || wy < 5 || wy > one - wx)
    return false;
  int64_t left, right, red_inv, green_inv;  // the products over 7 cannot overflow
  png_muldiv(&left, gx - bx, ry - by, 7);
  png_muldiv(&right, gy - by, rx - bx, 7);
  int64_t denominator = left - right;
  png_muldiv(&left, gx - bx, wy - by, 7);
  png_muldiv(&right, gy - by, wx - bx, 7);
  if (!png_muldiv(&red_inv, wy, denominator, left - right) || red_inv <= wy) return false;
  png_muldiv(&left, ry - by, wx - bx, 7);
  png_muldiv(&right, rx - bx, wy - by, 7);
  if (!png_muldiv(&green_inv, wy, denominator, left - right) || green_inv <= wy) return false;
  int64_t blue_scale = png_reciprocal(wy) - png_reciprocal(red_inv) - png_reciprocal(green_inv);
  if (blue_scale <= 0) return false;
  int64_t XYZ[9];  // red, green, blue; X, Y, Z each
  const int64_t xy[3][2] = {{rx, ry}, {gx, gy}, {bx, by}};
  for (int k = 0; k < 3; ++k)
    for (int j = 0; j < 3; ++j) {
      int64_t num = j < 2 ? xy[k][j] : one - xy[k][0] - xy[k][1];
      bool ok = k < 2 ? png_muldiv(&XYZ[3 * k + j], num, one, k ? green_inv : red_inv)
                      : png_muldiv(&XYZ[3 * k + j], num, blue_scale, one);
      if (!ok) return false;
    }
  // png_xy_from_XYZ, in libpng's 32-bit sums
  Xy back;
  int32_t dwhite = 0, white_x = 0, white_y = 0;
  for (int k = 0; k < 3; ++k) {
    int32_t d = int32_t(uint32_t(XYZ[3 * k]) + uint32_t(XYZ[3 * k + 1]) + uint32_t(XYZ[3 * k + 2]));
    if (!png_muldiv(&back.v[2 + 2 * k], XYZ[3 * k], one, d) || !png_muldiv(&back.v[3 + 2 * k], XYZ[3 * k + 1], one, d))
      return false;
    dwhite = int32_t(uint32_t(dwhite) + uint32_t(d));
    white_x = int32_t(uint32_t(white_x) + uint32_t(XYZ[3 * k]));
    white_y = int32_t(uint32_t(white_y) + uint32_t(XYZ[3 * k + 1]));
  }
  if (!png_muldiv(&back.v[0], white_x, one, dwhite) || !png_muldiv(&back.v[1], white_y, one, dwhite)) return false;
  return endpoints_match(c, back, 5);
}

struct ColourSpace {
  int64_t gamma = 0;  // 0: unset
  bool invalid = false, from_gama = false, from_srgb = false, from_chrm = false;

  // png_handle_gAMA -> png_colorspace_set_gamma
  void gama(int64_t g) {
    if (g < 16 || g > 625000000 || from_gama) {  // out of range, or a duplicate
      invalid = true;
      return;
    }
    if (invalid) return;
    int64_t test;
    // png_colorspace_check_gamma: an sRGB gamma stays unless this one is within 5% of it
    if (from_srgb && (!png_muldiv(&test, gamma, 100000, g) || gamma_significant(test))) return;
    gamma = g;
    from_gama = true;
  }
  // png_handle_sRGB -> png_colorspace_set_sRGB
  void srgb(int intent) {
    if (invalid) return;
    if (from_srgb || intent > 3) {  // a second sRGB, or an unknown rendering intent
      invalid = true;
      return;
    }
    gamma = 45455;
    from_srgb = true;
  }
  // png_handle_cHRM -> png_colorspace_set_chromaticities: a second cHRM, an
  // impossible one or one more than 0.001 from an earlier sRGB's invalidates
  void chrm(const Xy& c) {
    if (invalid) return;
    invalid = from_chrm || !chromaticities_valid(c) || (from_srgb && !endpoints_match(c, kSrgbXy, 100));
    from_chrm = true;
  }
  // png_handle_iCCP (its CRC is not looked at): a chunk too short to hold a
  // profile is ignored; after sRGB (or an sRGB profile) it is one profile too
  // many; else a keyword of 1-79 bytes, compression 0 and a profile that
  // passes png_icc_check_length, _header and _tag_table, or the colour space
  // is invalid. A profile libpng knows as sRGB (png_icc_set_sRGB) counts as
  // an sRGB chunk of the profile's intent; any other changes nothing.
  void iccp(const uint8_t* body, uint32_t len, int color);
};

// png_sRGB_checks (png.c): the ICC sRGB profiles libpng recognises, by
// Adler-32, CRC-32, length, rendering intent and the header's MD5 field
struct KnownSrgb {
  uint32_t adler, crc, length, intent, md5[4];
};
const KnownSrgb kKnownSrgb[] = {
    {0x0a3fd9f6, 0x3b8772b9, 3048, 0, {0x29f83dde, 0xaff255ae, 0x7842fae4, 0xca83390d}},  // black scaled
    {0x4909e5e1, 0x427ebb21, 3052, 1, {0xc95bd637, 0xe95d8a3b, 0x0df38f99, 0xc1320389}},  // no black scaling
    {0xfd2144a1, 0x306fd8ae, 60988, 0, {0xfc663378, 0x37e2886b, 0xfd72e983, 0x8228f1b8}},  // v4 display class
    {0x209c35d2, 0xbbef7812, 60960, 0, {0x34562abf, 0x994ccd06, 0x6d2c5721, 0xd0d68c5d}},  // v4 preference
    {0xa054d762, 0x5d5129ce, 3024, 1, {0, 0, 0, 0}},                                        // noBPC
    {0xf784f3fb, 0x182ea552, 3144, 0, {0, 0, 0, 0}},  // HP-Microsoft v2 perceptual
    {0x0398f3fc, 0xf29e526d, 3144, 1, {0, 0, 0, 0}},  // HP-Microsoft v2 media-relative
};

// png_compare_ICC_profile_with_sRGB: the first entry whose MD5 field,
// length and intent match decides, by its Adler-32 and CRC-32
bool known_srgb(const std::vector<uint8_t>& profile) {
  const uint8_t* p = profile.data();
  for (const KnownSrgb& k : kKnownSrgb) {
    if (be32(p + 84) != k.md5[0] || be32(p + 88) != k.md5[1] || be32(p + 92) != k.md5[2] ||
        be32(p + 96) != k.md5[3])
      continue;
    if (be32(p) == k.length && be32(p + 64) == k.intent)
      return adler32(p, k.length) == k.adler && crc32(p, k.length) == k.crc;
  }
  return false;
}

void ColourSpace::iccp(const uint8_t* body, uint32_t len, int color) {
  if (len < 14 || invalid) return;
  if (from_srgb) {  // "too many profiles"
    invalid = true;
    return;
  }
  const uint32_t head = std::min<uint32_t>(81, len);  // keyword, its 0 and the method
  if (len - head < 11) return;
  uint32_t kl = 0;
  while (kl < 80 && kl < head && body[kl]) ++kl;
  invalid = true;  // until the profile passes
  if (kl < 1 || kl > 79 || kl + 1 >= head || body[kl + 1] != 0) return;
  const uint8_t* z = body + kl + 2;
  const size_t zn = len - kl - 2;
  std::vector<uint8_t> profile;
  try {
    std::vector<uint8_t> h = Inflater(z, zn, 132, kPrefix).run();
    const uint8_t* p = h.data();
    const uint32_t length = be32(p), tags = be32(p + 128), space = be32(p + 16), cls = be32(p + 12),
                   pcs = be32(p + 20);
    if (length < 132 || length > 8000000) return;  // PNG_USER_CHUNK_MALLOC_MAX
    if (p[8] > 3 && (length & 3)) return;
    if (tags > 357913930 || length < 132 + 12 * tags) return;
    if (be32(p + 64) >= 0xffff || be32(p + 36) != 0x61637370) return;  // intent, 'acsp'
    if (space == 0x52474220 ? !(color & 2) : space == 0x47524159 ? (color & 2) : true) return;  // 'RGB ', 'GRAY'
    if (cls == 0x61627374 || cls == 0x6c696e6b) return;        // 'abst', 'link'
    if (pcs != 0x58595a20 && pcs != 0x4c616220) return;        // 'XYZ ', 'Lab '
    profile = Inflater(z, zn, length, kPrefix).run();
    for (uint32_t t = 0; t < tags; ++t) {
      const uint32_t start = be32(profile.data() + 132 + 12 * t + 4), size = be32(profile.data() + 132 + 12 * t + 8);
      if (start > length || size > length - start) return;
    }
  } catch (const Fail&) {
    return;  // the profile's bytes did not all come
  }
  invalid = false;
  if (known_srgb(profile)) srgb(int(be32(profile.data() + 64)));
}

void build_8bit_table(uint8_t* table, int64_t gamma) {
  bool sig = gamma_significant(gamma);
  for (int i = 0; i < 256; ++i)
    table[i] = (sig && i > 0 && i < 255) ? uint8_t(std::floor(255 * std::pow(i / 255., gamma * .00001) + .5))
                                         : uint8_t(i);
}

// PNG_sRGB_FROM_LINEAR(w * 65535) for a linear 8-bit w: the sRGB encoding of
// w / 255, rounded, except at w = 110 and 129, whose values lie within 0.01
// of a half and which libpng's interpolated tables (png_sRGB_base/delta)
// round the other way
uint8_t srgb_from_linear8(int w) {
  static const auto table = [] {
    std::vector<uint8_t> t(256);
    for (int i = 0; i < 256; ++i) {
      double x = i / 255.;
      double s = x <= 0.0031308 ? 12.92 * x : 1.055 * std::pow(x, 1 / 2.4) - 0.055;
      t[i] = uint8_t(std::floor(255 * s + .5));
    }
    t[110] = 176;
    t[129] = 188;
    return t;
  }();
  return table[w];
}

uint8_t png_composite8(int fg, int alpha, int bg) {
  unsigned temp = unsigned(fg * alpha + bg * (255 - alpha) + 128);
  return uint8_t(((temp + (temp >> 8)) >> 8) & 0xFF);
}

uint16_t png_composite16(uint32_t fg, uint32_t alpha, uint32_t bg) {
  uint32_t temp = fg * alpha + bg * (65535 - alpha) + 32768;
  return uint16_t(0xFFFF & ((temp + (temp >> 16)) >> 16));
}

// png_do_scale_16_to_8 on one sample
int png_scale16(int v) {
  int32_t hi = v >> 8, lo = v & 0xFF;
  return int(hi + ((((lo - hi + 128) * 65535)) >> 24));
}

struct PngInfo {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0, channels = 0;
  std::vector<uint8_t> palette;  // 3 * n
  std::vector<uint8_t> trns;     // raw tRNS payload
  bool has_trns = false;
  int64_t file_gamma = 0;  // libpng's colour-space gamma (gAMA, sRGB, cHRM), 0 when unset
  int sig_bit = 0;         // sBIT's grey, or its largest of red, green and blue; 0 when absent
};

// The ancillary chunks that change libpng's output, as its reader takes
// them (pngrutil.c): gAMA, sRGB, cHRM and sBIT before PLTE and IDAT, tRNS
// before IDAT (and after PLTE for a palette), each of its exact length or
// ignored; sBIT and tRNS once, sBIT with every value in 1..bit depth (8 for
// a palette), a palette's tRNS no longer than the palette.
void png_ancillary_chunk(const uint8_t* type, const uint8_t* body, uint32_t len, bool plte, bool idat,
                         PngInfo* info, ColourSpace* cs, bool* have_sbit) {
  if (idat) return;
  int color = info->color;
  if (!std::memcmp(type, "tRNS", 4)) {
    bool ok = color == 0 ? len == 2 : color == 2 ? len == 6
            : color == 3 ? plte && len && len <= info->palette.size() / 3 : false;
    if (ok && !info->has_trns) {
      info->trns.assign(body, body + len);
      info->has_trns = true;
    }
    return;
  }
  if (plte) return;
  if (!std::memcmp(type, "gAMA", 4)) {
    if (len == 4) cs->gama(be32(body) > 0x7FFFFFFFu ? -1 : int64_t(be32(body)));
  } else if (!std::memcmp(type, "sRGB", 4)) {
    if (len == 1) cs->srgb(body[0]);
  } else if (!std::memcmp(type, "cHRM", 4)) {
    if (len != 32) return;
    Xy c;
    for (int i = 0; i < 8; ++i) {
      if (be32(body + 4 * i) > 0x7FFFFFFFu) return;
      c.v[i] = be32(body + 4 * i);
    }
    cs->chrm(c);
  } else if (!std::memcmp(type, "sBIT", 4)) {
    uint32_t want = color == 3 ? 3 : uint32_t(info->channels);
    int depth = color == 3 ? 8 : info->depth;
    if (*have_sbit || len != want) return;
    for (uint32_t i = 0; i < len; ++i)
      if (body[i] == 0 || body[i] > depth) return;
    *have_sbit = true;
    info->sig_bit = (color & 2) ? std::max({body[0], body[1], body[2]}) : body[0];
  }
}

// the chunks libpng 1.6's reader has a handler for (pngread.c png_read_info)
bool png_known_chunk(const uint8_t* type) {
  static const char* const kKnown[] = {"IHDR", "PLTE", "IDAT", "IEND", "bKGD", "cHRM", "eXIf", "gAMA", "hIST", "iCCP",
                                       "iTXt", "oFFs", "pCAL", "pHYs", "sBIT", "sCAL", "sPLT", "sRGB", "tEXt", "tIME",
                                       "tRNS", "zTXt"};
  for (const char* k : kKnown)
    if (!std::memcmp(type, k, 4)) return true;
  return false;
}

// Decode to samples: [h][w][channels] at the file's bit depth. Under kNative
// an ancillary chunk whose CRC fails is dropped, as libpng does; a critical
// one, and under kPil any, fails.
std::vector<uint16_t> png_samples(const uint8_t* d, size_t n, int convention, PngInfo* info) {
  if (n < 8 || std::memcmp(d, kPngSig, 8) != 0) fail(kNotImage);
  static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
  size_t pos = 8;
  std::vector<uint8_t> idat;
  std::vector<size_t> windows;  // the reader's pieces of the IDAT data (see Inflater)
  const size_t piece = convention == kNative ? 8192 : 65536;
  bool header = false, end = false, plte = false, have_sbit = false;
  ColourSpace cs;
  while (!end) {
    // libpng's simplified reader stops at the end of the image data: what
    // follows the last IDAT (IEND included) is never read
    if (convention == kNative && !idat.empty() && (pos + 8 > n || std::memcmp(d + pos + 4, "IDAT", 4))) break;
    if (pos + 12 > n) fail(kCorrupt);  // truncated before IEND
    uint32_t len = be32(d + pos);
    if (len > n - pos - 12) fail(kCorrupt);
    const uint8_t* type = d + pos + 4;
    const uint8_t* body = d + pos + 8;
    // libpng reads IHDR once, before every chunk it knows ("missing IHDR",
    // "out of place"); an unknown chunk may come first
    bool ihdr = !std::memcmp(type, "IHDR", 4);
    if (convention == kNative && (header ? ihdr : !ihdr && png_known_chunk(type))) fail(kCorrupt);
    if (convention == kNative && !std::memcmp(type, "iCCP", 4)) {  // read whatever its CRC
      if (!plte && idat.empty()) cs.iccp(body, len, info->color);
      pos += 12 + len;
      continue;
    }
    if (crc32(type, len + 4) != be32(body + len)) {
      if (convention != kNative || !(type[0] & 0x20)) fail(kCorrupt);
      pos += 12 + len;
      continue;
    }
    if (ihdr) {
      if (len != 13) fail(kCorrupt);
      info->w = be32(body);
      info->h = be32(body + 4);
      info->depth = body[8];
      info->color = body[9];
      info->interlace = body[12];
      if (body[10] != 0 || body[11] != 0 || info->interlace > 1) fail(kUnsupported);
      info->channels = info->color < 7 ? kChannels[info->color] : 0;
      header = true;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      if (len % 3 || len > 768) fail(kCorrupt);
      // png_handle_PLTE keeps 2^depth entries of a palette image's palette
      const uint32_t keep = convention == kNative && info->color == 3 ? std::min(len, 3u << info->depth) : len;
      info->palette.assign(body, body + keep);
      plte = true;
    } else if (convention == kPil && !std::memcmp(type, "iCCP", 4)) {
      // PIL's chunk_iCCP raises on a compression method other than 0 (the
      // byte after the keyword's 0, or the first byte where there is none)
      const uint8_t* nul = static_cast<const uint8_t*>(std::memchr(body, 0, len));
      const size_t at = nul ? size_t(nul - body) + 1 : 0;
      if (at >= len || body[at] != 0) fail(kCorrupt);
    } else if (!std::memcmp(type, "tRNS", 4) || !std::memcmp(type, "gAMA", 4) || !std::memcmp(type, "sRGB", 4) ||
               !std::memcmp(type, "cHRM", 4) || !std::memcmp(type, "sBIT", 4)) {
      if (header) png_ancillary_chunk(type, body, len, plte, !idat.empty(), info, &cs, &have_sbit);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      const size_t start = idat.size();
      idat.insert(idat.end(), body, body + len);
      for (size_t e = start + piece; e < idat.size(); e += piece) windows.push_back(e);
      if (len) windows.push_back(idat.size());
    } else if (!std::memcmp(type, "IEND", 4)) {
      end = true;
    } else if (!(type[0] & 0x20)) {
      fail(kUnsupported);  // an unknown critical chunk
    }
    pos += 12 + len;
  }
  if (!header || idat.empty()) fail(kCorrupt);
  info->file_gamma = cs.gamma;
  int depth = info->depth, color = info->color;
  if (color > 6 || !kChannels[color]) fail(kCorrupt);
  bool ok_depth = (color == 0 && (depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16)) ||
                  (color == 3 && (depth == 1 || depth == 2 || depth == 4 || depth == 8)) ||
                  ((color == 2 || color == 4 || color == 6) && (depth == 8 || depth == 16));
  if (!ok_depth) fail(kCorrupt);
  if (color == 3 && info->palette.empty()) fail(kCorrupt);
  uint32_t w = info->w, h = info->h;
  if (!w || !h || uint64_t(w) * h > (uint64_t(1) << 28)) fail(kUnsupported);
  int ch = info->channels = kChannels[color];
  int pixel_bits = ch * depth;
  int bpp = std::max(1, pixel_bits / 8);
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = info->interlace ? kAdam7 : kWhole;
  int npass = info->interlace ? 7 : 1;
  size_t expect = 0;
  for (int p = 0; p < npass; ++p) {
    size_t pw = (w + passes[p][2] - 1 - passes[p][0]) / passes[p][2];
    size_t ph = (h + passes[p][3] - 1 - passes[p][1]) / passes[p][3];
    if (w <= uint32_t(passes[p][0]) || h <= uint32_t(passes[p][1])) pw = ph = 0;
    if (pw && ph) expect += ph * (1 + (pw * pixel_bits + 7) / 8);
  }
  std::vector<uint8_t> raw =
      Inflater(idat.data(), idat.size(), expect, convention == kNative ? kReadLibpng : kReadPil, &windows).run();
  std::vector<uint16_t> samples(size_t(w) * h * ch);
  size_t at = 0;
  for (int p = 0; p < npass; ++p) {
    uint32_t x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
    if (w <= x0 || h <= y0) continue;
    size_t pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    size_t stride = (pw * pixel_bits + 7) / 8;
    std::vector<uint8_t> prev(stride, 0), cur(stride);
    for (size_t y = 0; y < ph; ++y) {
      int filter = raw[at];
      const uint8_t* line = raw.data() + at + 1;
      at += stride + 1;
      for (size_t i = 0; i < stride; ++i) {
        int a = i >= size_t(bpp) ? cur[i - bpp] : 0, b = prev[i], c = i >= size_t(bpp) ? prev[i - bpp] : 0;
        int pred;
        switch (filter) {
          case 0: pred = 0; break;
          case 1: pred = a; break;
          case 2: pred = b; break;
          case 3: pred = (a + b) >> 1; break;
          case 4: {
            int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
            pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            break;
          }
          default: fail(kCorrupt);
        }
        cur[i] = uint8_t(line[i] + pred);
      }
      size_t oy = y0 + y * dy;
      for (size_t x = 0; x < pw; ++x) {
        uint16_t* dst = samples.data() + ((oy * w) + x0 + x * dx) * ch;
        for (int c = 0; c < ch; ++c) {
          size_t bit = (x * ch + c) * size_t(depth);
          uint16_t v;
          if (depth == 16) {
            v = uint16_t((cur[bit / 8] << 8) | cur[bit / 8 + 1]);
          } else if (depth == 8) {
            v = cur[bit / 8];
          } else {
            v = uint16_t((cur[bit / 8] >> (8 - depth - bit % 8)) & ((1 << depth) - 1));
          }
          dst[c] = v;
        }
      }
      prev.swap(cur);
    }
  }
  return samples;
}

// what PIL's Image.open(p).convert("RGB") gives
void png_to_rgb_pil(const PngInfo& info, const std::vector<uint16_t>& s, uint8_t* out) {
  size_t n = size_t(info.w) * info.h;
  int ch = info.channels, depth = info.depth;
  for (size_t i = 0; i < n; ++i) {
    const uint16_t* p = s.data() + i * ch;
    uint8_t* o = out + i * 3;
    if (info.color == 3) {
      size_t k = p[0];
      for (int c = 0; c < 3; ++c) o[c] = 3 * k + c < info.palette.size() ? info.palette[3 * k + c] : 0;
      continue;
    }
    int rgb[3];
    for (int c = 0; c < 3; ++c) {
      int v = p[(info.color == 2 || info.color == 6) ? c : 0];
      if (depth == 16) {
        // grey 16 opens as "I;16" and converts with clipping; the rest keep the high byte
        v = info.color == 0 ? std::min(v, 255) : v >> 8;
      } else if (depth < 8) {
        v = v * (255 / ((1 << depth) - 1));
      }
      rgb[c] = v;
    }
    for (int c = 0; c < 3; ++c) o[c] = uint8_t(rgb[c]);
  }
}

// what libpng's png_image_finish_read(PNG_FORMAT_RGB, background NULL) writes
// into a zeroed buffer
void png_to_rgb_native(const PngInfo& info, const std::vector<uint16_t>& s, uint8_t* out) {
  size_t n = size_t(info.w) * info.h;
  int ch = info.channels, depth = info.depth, color = info.color;
  const int64_t screen = 220000;  // sRGB output
  bool sixteen = depth == 16;
  int64_t file_gamma = info.file_gamma ? info.file_gamma : (sixteen ? 100000 : 45455);
  bool alpha_channel = color == 4 || color == 6;
  bool trns = info.has_trns && color != 3 && !alpha_channel;
  // the transparent colour of a tRNS chunk, at the file's bit depth
  uint16_t trns_key[3] = {0, 0, 0};
  if (trns) {
    size_t want = color == 0 ? 2 : 6;  // the chunk's length, checked when it was read
    for (size_t c = 0; c < want / 2; ++c) trns_key[c] = uint16_t((info.trns[2 * c] << 8) | info.trns[2 * c + 1]);
  }
  bool has_alpha = alpha_channel || trns || (color == 3 && info.has_trns);
  // libpng corrects the gamma of a file without alpha only where file x
  // screen lies 5% or more from 1 (png_gamma_threshold sets PNG_GAMMA); with
  // alpha it composes through its tables whatever the gamma
  bool correct = gamma_threshold(screen, file_gamma);

  if (!sixteen) {
    uint8_t gamma_table[256], to_1[256], from_1[256];
    build_8bit_table(gamma_table, png_reciprocal2(file_gamma, screen));
    build_8bit_table(to_1, png_reciprocal(file_gamma));
    build_8bit_table(from_1, png_reciprocal(screen));
    // palette: expanded to RGB, with an alpha from tRNS (255 past its end)
    std::vector<uint8_t> pal_alpha(info.palette.size() / 3, 255);
    for (size_t k = 0; k < pal_alpha.size() && k < info.trns.size() && color == 3; ++k) pal_alpha[k] = info.trns[k];
    for (size_t i = 0; i < n; ++i) {
      const uint16_t* p = s.data() + i * ch;
      uint8_t* o = out + i * 3;
      int v[3], a = 255;
      if (color == 3) {
        size_t k = p[0];
        if (3 * k + 2 < info.palette.size()) {  // libpng expands an index past the palette to black
          for (int c = 0; c < 3; ++c) v[c] = info.palette[3 * k + c];
          a = pal_alpha[k];
        } else {
          v[0] = v[1] = v[2] = 0;
        }
      } else {
        int scale = depth < 8 ? 255 / ((1 << depth) - 1) : 1;
        bool colour = color == 2 || color == 6;
        for (int c = 0; c < 3; ++c) v[c] = p[colour ? c : 0] * scale;
        if (alpha_channel) {
          a = p[colour ? 3 : 1];
        } else if (trns) {
          bool match = colour ? (p[0] == trns_key[0] && p[1] == trns_key[1] && p[2] == trns_key[2])
                              : p[0] == trns_key[0];
          a = match ? 0 : 255;
        }
      }
      if (!has_alpha) {
        for (int c = 0; c < 3; ++c) o[c] = correct ? gamma_table[v[c]] : uint8_t(v[c]);
      } else if (a == 0) {
        o[0] = o[1] = o[2] = 0;
      } else if (a == 255) {
        for (int c = 0; c < 3; ++c) o[c] = gamma_table[v[c]];
      } else if (color == 3) {
        // a palette is composited once, entry by entry, back to the screen's
        // gamma (png_init_read_transformations), rounding (x + 128) / 255
        for (int c = 0; c < 3; ++c) o[c] = from_1[(to_1[v[c]] * a + 128) / 255];
      } else {
        for (int c = 0; c < 3; ++c) o[c] = srgb_from_linear8(png_composite8(to_1[v[c]], a, 0));
      }
    }
    return;
  }

  // 16-bit samples: gamma on the top 16 - shift bits, then scale to 8. The
  // shift is png_build_gamma_table's: the bits sBIT calls insignificant, at
  // least 5 (PNG_MAX_GAMMA_8 keeps 11) and at most 8
  int shift = info.sig_bit > 0 && info.sig_bit < 16 ? 16 - info.sig_bit : 0;
  shift = std::min(std::max(shift, 16 - 11), 8);
  const int max = (1 << (16 - shift)) - 1;
  std::vector<uint16_t> to8(size_t(max) + 1);  // png_build_16to8_table
  {
    int64_t g = png_product2(file_gamma, screen);
    uint32_t last = 0;
    for (int i = 0; i < 255; ++i) {
      uint32_t outv = uint32_t(i) * 257;
      uint32_t bound = uint32_t(std::floor(65535. * std::pow((outv + 128) / 65535., g * .00001) + .5));
      bound = (bound * uint32_t(max) + 32768) / 65535 + 1;
      while (last < bound && last < to8.size()) to8[last++] = uint16_t(outv);
    }
    while (last < to8.size()) to8[last++] = 65535;
  }
  std::vector<uint16_t> to_1(size_t(max) + 1);  // png_build_16bit_table(1 / file gamma)
  {
    int64_t g = png_reciprocal(file_gamma);
    for (int ig = 0; ig <= max; ++ig)
      to_1[ig] = gamma_significant(g) ? uint16_t(std::floor(65535. * std::pow(ig * (1. / max), g * .00001) + .5))
                                      : uint16_t((uint32_t(ig) * 65535 + (1u << (15 - shift))) / uint32_t(max));
  }
  for (size_t i = 0; i < n; ++i) {
    const uint16_t* p = s.data() + i * ch;
    uint8_t* o = out + i * 3;
    bool colour = color == 2 || color == 6;
    int v[3];
    for (int c = 0; c < 3; ++c) v[c] = p[colour ? c : 0];
    int a = 65535;
    if (alpha_channel) {
      a = p[colour ? 3 : 1];
    } else if (trns) {
      bool match = colour ? (p[0] == trns_key[0] && p[1] == trns_key[1] && p[2] == trns_key[2])
                          : p[0] == trns_key[0];
      a = match ? 0 : 65535;
    }
    if (!has_alpha || a == 65535) {
      for (int c = 0; c < 3; ++c) o[c] = uint8_t(png_scale16(correct || has_alpha ? to8[v[c] >> shift] : v[c]));
      continue;
    }
    int a8 = png_scale16(a);
    for (int c = 0; c < 3; ++c) {
      int w8 = a == 0 ? 0 : png_scale16(png_composite16(to_1[v[c] >> shift], uint32_t(a), 0));
      o[c] = a8 == 0 ? 0 : (a8 < 255 ? srgb_from_linear8(w8) : uint8_t(w8));
    }
  }
  if (info.interlace && !has_alpha) {
    // libpng's simplified reader, 16-bit Adam7 to 8 bits without alpha: each
    // of the 7 passes reads every row into one row buffer, which only that
    // pass's pixels update, and the whole buffer lands in the output row.
    // So the last pass leaves row 2k holding row 2k - 1 (k >= 1), and row 0
    // what the first six passes last wrote in each column.
    static const int kPass[6][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2}};
    size_t w = info.w, h = info.h;
    std::vector<uint8_t> row0(w * 3, 0);
    for (const auto& p : kPass)
      for (size_t y = size_t(p[1]); y < h; y += size_t(p[3]))
        for (size_t x = size_t(p[0]); x < w; x += size_t(p[2])) std::memcpy(&row0[3 * x], out + (y * w + x) * 3, 3);
    for (size_t y = h - 1 - (h - 1) % 2; y >= 2; y -= 2) std::memcpy(out + y * w * 3, out + (y - 1) * w * 3, w * 3);
    std::memcpy(out, row0.data(), w * 3);
  }
}

void decode_png(const uint8_t* d, size_t n, int convention, Image* img) {
  PngInfo info;
  std::vector<uint16_t> samples = png_samples(d, n, convention, &info);
  img->w = int(info.w);
  img->h = int(info.h);
  img->rgb.assign(size_t(info.w) * info.h * 3, 0);
  if (convention == kNative) {
    png_to_rgb_native(info, samples, img->rgb.data());
  } else {
    png_to_rgb_pil(info, samples, img->rgb.data());
  }
}

// ------------------------------------------------------------------- JPEG

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct JpegHuff {
  uint8_t vals[256];
  int maxcode[18];
  int valoffset[18];
  uint16_t fast[1 << 9];  // (length << 8) | value for codes of <= 9 bits, else 0
  bool defined = false;
};

void build_jpeg_huff(JpegHuff* h, const uint8_t* bits, const uint8_t* vals) {
  int total = 0;
  for (int l = 0; l < 16; ++l) total += bits[l];
  if (total > 256) fail(kCorrupt);
  std::memcpy(h->vals, vals, size_t(total));
  std::memset(h->fast, 0, sizeof(h->fast));
  int code = 0, p = 0;
  for (int l = 1; l <= 16; ++l) {
    int cnt = bits[l - 1];
    if (cnt) {
      h->valoffset[l] = p - code;
      for (int k = 0; k < cnt; ++k, ++code, ++p) {
        if (l <= 9)
          for (int fill = code << (9 - l); fill < ((code + 1) << (9 - l)); ++fill)
            h->fast[fill] = uint16_t((l << 8) | vals[p]);
      }
      h->maxcode[l] = code - 1;
    } else {
      h->maxcode[l] = -1;
    }
    if (code > (1 << l)) fail(kCorrupt);
    code <<= 1;
  }
  h->maxcode[17] = 0x7FFFFFFF;
  h->defined = true;
}

struct JpegComponent {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;                   // allocated blocks (MCU-padded)
  int width_in_blocks = 0, height_in_blocks = 0;
  int dw = 0, dh = 0;                   // downsampled size
  std::vector<int16_t> coef;            // bh * bw * 64, natural order
  uint16_t quant[64];
  bool quant_latched = false;
  int dc_pred = 0;
  int dc_tbl = 0, ac_tbl = 0;
};

class BitIn {
 public:
  BitIn(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}
  size_t pos() const { return pos_; }
  bool overrun() const { return overrun_; }
  bool ended() const { return ended_; }

  void fill() {
    while (cnt_ <= 56) {
      uint64_t b = 0;
      if (!marker_ && pos_ < n_) {
        b = d_[pos_];
        if (b == 0xFF) {
          if (pos_ + 1 >= n_) {
            marker_ = ended_ = true;
            b = 0;
          } else if (d_[pos_ + 1] == 0) {
            pos_ += 2;
          } else {
            marker_ = true;  // a marker: the scan's data ends here
            b = 0;
          }
        } else {
          ++pos_;
        }
        if (marker_) fake_ += 8;
      } else {
        if (pos_ >= n_) ended_ = true;
        fake_ += 8;
      }
      buf_ |= b << (56 - cnt_);
      cnt_ += 8;
    }
  }
  int peek(int k) {
    if (cnt_ < k) fill();
    return int(buf_ >> (64 - k));
  }
  void skip(int k) {
    buf_ <<= k;
    cnt_ -= k;
    if (cnt_ < fake_) {
      overrun_ = true;
      fake_ = cnt_;
    }
  }
  int bits(int k) {
    if (!k) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  int decode(const JpegHuff& h) {
    int look = peek(9);
    uint16_t e = h.fast[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = 10, code = 0;
    for (; l <= 16; ++l) {
      code = peek(l);
      if (code <= h.maxcode[l]) break;
    }
    if (l > 16) fail(kCorrupt);
    skip(l);
    return h.vals[code + h.valoffset[l]];
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }
  // At a restart interval: drop the bits left in this byte, read RSTn.
  void restart(int expect) {
    if (cnt_ - fake_ >= 8) fail(kCorrupt);  // a whole byte of the interval left unread
    buf_ = 0;
    cnt_ = 0;
    fake_ = 0;
    size_t p = pos_;
    if (p >= n_ || d_[p] != 0xFF) fail(kCorrupt);  // no RSTn where the interval ends
    while (p < n_ && d_[p] == 0xFF) ++p;
    if (p >= n_ || d_[p] != 0xD0 + expect) fail(kCorrupt);
    pos_ = p + 1;
    marker_ = ended_ = false;
  }
  // The scan's end: skip to the marker that follows it.
  void finish() {
    size_t p = pos_;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0 && d_[p + 1] != 0xFF)) ++p;
    pos_ = p;
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_;
  uint64_t buf_ = 0;
  int cnt_ = 0, fake_ = 0;
  bool marker_ = false, overrun_ = false, ended_ = false;
};

// jidctint.c: the accurate integer inverse DCT
namespace idct {
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069, F2_053 = 16819, F2_562 = 20995,
                  F3_072 = 25172;
inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// range_limit[x & 1023] of jdmaster.c's post-IDCT table, centred on 128
const uint8_t* limit_table() {
  static const auto t = [] {
    std::vector<uint8_t> v(1024);
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) v[i] = uint8_t(i + 128);
      else if (i < 512) v[i] = 255;
      else if (i < 896) v[i] = 0;
      else v[i] = uint8_t(i - 896);
    }
    return v;
  }();
  return t.data();
}

void block(const int16_t* in, const uint16_t* q, uint8_t* out, size_t stride) {
  const uint8_t* limit = limit_table();
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = int(int64_t(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits), tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, s));
    wp[56] = int(descale(tmp10 - tmp3, s));
    wp[8] = int(descale(tmp11 + tmp2, s));
    wp[48] = int(descale(tmp11 - tmp2, s));
    wp[16] = int(descale(tmp12 + tmp1, s));
    wp[40] = int(descale(tmp12 - tmp1, s));
    wp[24] = int(descale(tmp13 + tmp0, s));
    wp[32] = int(descale(tmp13 - tmp0, s));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dc = limit[int(descale(wp[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    op[0] = limit[int(descale(tmp10 + tmp3, s)) & 1023];
    op[7] = limit[int(descale(tmp10 - tmp3, s)) & 1023];
    op[1] = limit[int(descale(tmp11 + tmp2, s)) & 1023];
    op[6] = limit[int(descale(tmp11 - tmp2, s)) & 1023];
    op[2] = limit[int(descale(tmp12 + tmp1, s)) & 1023];
    op[5] = limit[int(descale(tmp12 - tmp1, s)) & 1023];
    op[3] = limit[int(descale(tmp13 + tmp0, s)) & 1023];
    op[4] = limit[int(descale(tmp13 - tmp0, s)) & 1023];
  }
}
}  // namespace idct

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  void run(Image* img) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail(kNotImage);
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // a stray RSTn: nothing to read
      size_t len = segment_length();
      const uint8_t* s = d_ + pos_ + 2;
      size_t body = len - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: frame(s, body, m == 0xC2); break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA: case 0xCB:
        case 0xCC: case 0xCD: case 0xCE: case 0xCF: case 0xDC:
          fail(kUnsupported);  // lossless, hierarchical, arithmetic coding, DNL
        case 0xC4: huffman(s, body); break;
        case 0xDB: quant(s, body); break;
        case 0xDD:
          if (body < 2) fail(kCorrupt);
          restart_interval_ = (s[0] << 8) | s[1];
          break;
        case 0xE0:
          if (body >= 5 && !std::memcmp(s, "JFIF\0", 5)) jfif_ = true;
          break;
        case 0xEE:
          if (body >= 12 && !std::memcmp(s, "Adobe", 5)) {
            adobe_ = true;
            adobe_transform_ = s[11];
          }
          break;
        case 0xDA:
          pos_ += len;
          scan(s, body);
          continue;
        default: break;  // APPn, COM and the rest: skipped
      }
      pos_ += len;
    }
    if (comps_.empty() || !scans_) fail(kCorrupt);
    output(img);
  }

 private:
  int next_marker() {
    if (pos_ >= n_ || d_[pos_] != 0xFF) fail(kCorrupt);
    while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;  // fill bytes
    if (pos_ >= n_) fail(kCorrupt);
    return d_[pos_++];
  }
  size_t segment_length() {
    if (pos_ + 2 > n_) fail(kCorrupt);
    size_t len = (size_t(d_[pos_]) << 8) | d_[pos_ + 1];
    if (len < 2 || pos_ + len > n_) fail(kCorrupt);
    return len;
  }

  void frame(const uint8_t* s, size_t n, bool progressive) {
    if (!comps_.empty() || n < 6) fail(kCorrupt);
    if (s[0] != 8) fail(kUnsupported);  // 12-bit
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    int nc = s[5];
    if (!height_) fail(kUnsupported);  // DNL
    if (!width_ || n < size_t(6 + 3 * nc)) fail(kCorrupt);
    if (nc != 1 && nc != 3) fail(kUnsupported);  // CMYK, YCCK
    progressive_ = progressive;
    comps_.resize(size_t(nc));
    for (int i = 0; i < nc; ++i) {
      JpegComponent& c = comps_[size_t(i)];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2) fail(kUnsupported);
      if (c.tq > 3) fail(kCorrupt);
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      c.dw = (width_ * c.h + hmax_ - 1) / hmax_;
      c.dh = (height_ * c.v + vmax_ - 1) / vmax_;
      c.width_in_blocks = (c.dw + 7) / 8;
      c.height_in_blocks = (c.dh + 7) / 8;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
  }

  void huffman(const uint8_t* s, size_t n) {
    size_t p = 0;
    while (p < n) {
      if (p + 17 > n) fail(kCorrupt);
      int tc = s[p] >> 4, th = s[p] & 15;
      if (tc > 1 || th > 3) fail(kCorrupt);
      int total = 0;
      for (int l = 0; l < 16; ++l) total += s[p + 1 + l];
      if (p + 17 + total > n) fail(kCorrupt);
      build_jpeg_huff(&huff_[tc][th], s + p + 1, s + p + 17);
      p += 17 + size_t(total);
    }
  }

  void quant(const uint8_t* s, size_t n) {
    size_t p = 0;
    while (p < n) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      if (pq > 1 || tq > 3) fail(kCorrupt);
      if (p + 1 + 64 * (pq + 1) > n) fail(kCorrupt);
      for (int k = 0; k < 64; ++k)
        qt_[tq][kZigzag[k]] = pq ? uint16_t((s[p + 1 + 2 * k] << 8) | s[p + 2 + 2 * k]) : s[p + 1 + k];
      qt_defined_[tq] = true;
      p += 1 + 64 * size_t(pq + 1);
    }
  }

  void scan(const uint8_t* s, size_t n) {
    if (comps_.empty() || n < 1) fail(kCorrupt);
    int ns = s[0];
    if (ns < 1 || ns > 4 || n < size_t(4 + 2 * ns)) fail(kCorrupt);
    std::vector<JpegComponent*> cs;
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      JpegComponent* found = nullptr;
      for (auto& c : comps_)
        if (c.id == id) found = &c;
      if (!found) fail(kCorrupt);
      found->dc_tbl = s[2 + 2 * i] >> 4;
      found->ac_tbl = s[2 + 2 * i] & 15;
      if (found->dc_tbl > 3 || found->ac_tbl > 3) fail(kCorrupt);
      if (!found->quant_latched) {  // libjpeg latches a table at the component's first scan
        if (!qt_defined_[found->tq]) fail(kCorrupt);
        std::memcpy(found->quant, qt_[found->tq], sizeof(found->quant));
        found->quant_latched = true;
      }
      cs.push_back(found);
    }
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    if (progressive_) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13 || ah > 13) fail(kCorrupt);
    } else if (ss != 0 || se != 63 || ah || al) {
      fail(kCorrupt);
    }
    for (auto* c : cs) {
      bool dc = !progressive_ || ss == 0;
      bool ac = !progressive_ || ss > 0;
      if (dc && !(progressive_ && ah) && !huff_[0][c->dc_tbl].defined) fail(kCorrupt);
      if (ac && !huff_[1][c->ac_tbl].defined) fail(kCorrupt);
      c->dc_pred = 0;
    }
    BitIn in(d_, n_, pos_);
    int eobrun = 0;
    int mx = ns == 1 ? cs[0]->width_in_blocks : mcux_;
    int my = ns == 1 ? cs[0]->height_in_blocks : mcuy_;
    int restarts = 0, todo = restart_interval_;
    for (int y = 0; y < my; ++y) {
      for (int x = 0; x < mx; ++x) {
        if (restart_interval_ && todo == 0) {
          in.restart(restarts & 7);
          ++restarts;
          todo = restart_interval_;
          eobrun = 0;
          for (auto* c : cs) c->dc_pred = 0;
        }
        if (ns == 1) {
          JpegComponent* c = cs[0];
          block(in, c, &c->coef[(size_t(y) * c->bw + x) * 64], ss, se, ah, al, &eobrun);
        } else {
          for (auto* c : cs)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h)
                block(in, c, &c->coef[(size_t(y * c->v + v) * c->bw + x * c->h + h) * 64], ss, se, ah, al, &eobrun);
        }
        if (in.overrun()) fail(kCorrupt);
        --todo;
      }
    }
    if (in.overrun()) fail(kCorrupt);
    in.finish();
    if (in.ended()) fail(kCorrupt);  // truncated: the file ends inside the scan
    pos_ = in.pos();
    ++scans_;
  }

  void block(BitIn& in, JpegComponent* c, int16_t* b, int ss, int se, int ah, int al, int* eobrun) {
    if (!progressive_) {
      int t = in.decode(huff_[0][c->dc_tbl]);
      if (t > 11) fail(kCorrupt);
      c->dc_pred += t ? BitIn::extend(in.bits(t), t) : 0;
      b[0] = int16_t(c->dc_pred);
      const JpegHuff& ac = huff_[1][c->ac_tbl];
      for (int k = 1; k < 64;) {
        int rs = in.decode(ac), r = rs >> 4, sz = rs & 15;
        if (!sz) {
          if (r != 15) break;
          k += 16;
          continue;
        }
        k += r;
        if (k > 63) fail(kCorrupt);
        b[kZigzag[k++]] = int16_t(BitIn::extend(in.bits(sz), sz));
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (!ah) {
        int t = in.decode(huff_[0][c->dc_tbl]);
        if (t > 11) fail(kCorrupt);
        c->dc_pred += t ? BitIn::extend(in.bits(t), t) : 0;
        b[0] = int16_t(uint32_t(c->dc_pred) << al);
      } else if (in.bits(1)) {
        b[0] = int16_t(b[0] | (1 << al));
      }
      return;
    }
    const JpegHuff& ac = huff_[1][c->ac_tbl];
    if (!ah) {  // AC first pass
      if (*eobrun) {
        --*eobrun;
        return;
      }
      for (int k = ss; k <= se;) {
        int rs = in.decode(ac), r = rs >> 4, sz = rs & 15;
        if (!sz) {
          if (r < 15) {
            *eobrun = (1 << r) - 1;
            if (r) *eobrun += in.bits(r);
            break;
          }
          k += 16;
          continue;
        }
        k += r;
        if (k > 63) fail(kCorrupt);
        b[kZigzag[k++]] = int16_t(BitIn::extend(in.bits(sz), sz) * (1 << al));
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (!*eobrun) {
      for (; k <= se; ++k) {
        int rs = in.decode(ac), r = rs >> 4, sz = rs & 15, val = 0;
        if (sz) {
          if (sz != 1) fail(kCorrupt);
          val = in.bits(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += in.bits(r);
          break;
        }
        do {
          int16_t* coef = &b[kZigzag[k]];
          if (*coef) {
            if (in.bits(1) && !(*coef & p1)) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (val) {
          if (k > 63) fail(kCorrupt);
          b[kZigzag[k]] = int16_t(val);
        }
      }
    }
    if (*eobrun) {
      for (; k <= se; ++k) {
        int16_t* coef = &b[kZigzag[k]];
        if (*coef && in.bits(1) && !(*coef & p1)) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --*eobrun;
    }
  }

  // IDCT, upsample (jdsample.c, "fancy") and convert colour (jdcolor.c) into img
  void output(Image* img) {
    for (auto& c : comps_)
      if (!c.quant_latched) fail(kCorrupt);  // a component no scan coded
    size_t w = size_t(width_), h = size_t(height_);
    std::vector<std::vector<uint8_t>> full(comps_.size());
    for (size_t ci = 0; ci < comps_.size(); ++ci) {
      JpegComponent& c = comps_[ci];
      size_t pw = size_t(c.bw) * 8;
      std::vector<uint8_t> plane(pw * size_t(c.bh) * 8);
      for (int by = 0; by < c.height_in_blocks; ++by)
        for (int bx = 0; bx < c.width_in_blocks; ++bx)
          idct::block(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant, &plane[size_t(by) * 8 * pw + size_t(bx) * 8], pw);
      full[ci] = upsample(c, plane, pw, w, h);
    }
    img->w = width_;
    img->h = height_;
    img->rgb.resize(w * h * 3);
    uint8_t* o = img->rgb.data();
    if (comps_.size() == 1) {
      const uint8_t* g = full[0].data();
      for (size_t i = 0; i < w * h; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = g[i];
      return;
    }
    bool rgb = false;  // jdapimin.c default_decompress_parms
    if (jfif_) {
      rgb = false;
    } else if (adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
    }
    const uint8_t *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
    if (rgb) {
      for (size_t i = 0; i < w * h; ++i) {
        o[3 * i] = p0[i];
        o[3 * i + 1] = p1[i];
        o[3 * i + 2] = p2[i];
      }
      return;
    }
    static const struct Tables {
      int cr_r[256], cb_b[256];
      int64_t cr_g[256], cb_g[256];
      Tables() {
        const int64_t half = int64_t(1) << 15;
        auto fix = [](double x) { return int64_t(x * 65536 + 0.5); };
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
          cr_r[i] = int((fix(1.40200) * x + half) >> 16);
          cb_b[i] = int((fix(1.77200) * x + half) >> 16);
          cr_g[i] = -fix(0.71414) * x;
          cb_g[i] = -fix(0.34414) * x + half;
        }
      }
    } t;
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < w * h; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      o[3 * i] = clamp(y + t.cr_r[cr]);
      o[3 * i + 1] = clamp(y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * i + 2] = clamp(y + t.cb_b[cb]);
    }
  }

  // One component's plane [c.dh x c.dw of pw columns] -> [h x w] at full size.
  std::vector<uint8_t> upsample(const JpegComponent& c, const std::vector<uint8_t>& plane, size_t pw, size_t w,
                                size_t h) {
    std::vector<uint8_t> out(w * h);
    int he = hmax_ / c.h, ve = vmax_ / c.v;
    int dw = c.dw, dh = c.dh;
    auto row = [&](int r) { return plane.data() + size_t(std::clamp(r, 0, dh - 1)) * pw; };
    std::vector<uint8_t> line(size_t(dw) * 2 + 2);
    std::vector<int> colsum(static_cast<size_t>(dw));
    for (size_t oy = 0; oy < h; ++oy) {
      uint8_t* o = out.data() + oy * w;
      int iy = int(oy) / ve;
      if (he == 1 && ve == 1) {
        std::memcpy(o, row(iy), w);
      } else if (he == 2 && ve == 1) {
        const uint8_t* in = row(iy);
        if (dw > 2) {  // h2v1_fancy_upsample
          line[0] = in[0];
          line[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
          for (int x = 1; x < dw - 1; ++x) {
            int v = in[x] * 3;
            line[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
            line[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
          }
          line[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
          line[2 * dw - 1] = in[dw - 1];
        } else {
          for (int x = 0; x < dw; ++x) line[2 * x] = line[2 * x + 1] = in[x];
        }
        std::memcpy(o, line.data(), w);
      } else if (he == 1 && ve == 2) {  // h1v2_fancy_upsample
        bool below = oy & 1;
        const uint8_t *near = row(iy), *far = row(below ? iy + 1 : iy - 1);
        int bias = below ? 2 : 1;
        for (size_t x = 0; x < w; ++x) o[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
      } else {  // he == 2 && ve == 2
        if (dw > 2) {  // h2v2_fancy_upsample
          bool below = oy & 1;
          const uint8_t *near = row(iy), *far = row(below ? iy + 1 : iy - 1);
          for (int x = 0; x < dw; ++x) colsum[size_t(x)] = near[x] * 3 + far[x];
          line[0] = uint8_t((colsum[0] * 4 + 8) >> 4);
          line[1] = uint8_t((colsum[0] * 3 + colsum[1] + 7) >> 4);
          for (int x = 1; x < dw - 1; ++x) {
            line[2 * x] = uint8_t((colsum[size_t(x)] * 3 + colsum[size_t(x) - 1] + 8) >> 4);
            line[2 * x + 1] = uint8_t((colsum[size_t(x)] * 3 + colsum[size_t(x) + 1] + 7) >> 4);
          }
          line[2 * dw - 2] = uint8_t((colsum[size_t(dw) - 1] * 3 + colsum[size_t(dw) - 2] + 8) >> 4);
          line[2 * dw - 1] = uint8_t((colsum[size_t(dw) - 1] * 4 + 7) >> 4);
        } else {  // h2v2_upsample
          const uint8_t* in = row(iy);
          for (int x = 0; x < dw; ++x) line[2 * x] = line[2 * x + 1] = in[x];
        }
        std::memcpy(o, line.data(), w);
      }
    }
    return out;
  }

  const uint8_t* d_;
  size_t n_, pos_ = 0;
  std::vector<JpegComponent> comps_;
  JpegHuff huff_[2][4];
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {false, false, false, false};
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0, scans_ = 0;
  bool progressive_ = false, jfif_ = false, adobe_ = false;
  int adobe_transform_ = 1;
};

void decode_any(const uint8_t* d, size_t n, int convention, Image* img) {
  if (n >= 8 && !std::memcmp(d, kPngSig, 8)) {
    decode_png(d, n, convention, img);
  } else if (n >= 2 && d[0] == 0xFF && d[1] == 0xD8) {
    JpegDecoder(d, n).run(img);
  } else {
    fail(kNotImage);
  }
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  bool ok = size >= 0;
  if (ok) {
    out->resize(size_t(size));
    ok = std::fread(out->data(), 1, out->size(), f) == out->size();
  }
  std::fclose(f);
  return ok;
}

// ------------------------------------------------------------ JPEG encode

// ITU T.81 Annex K: the example quantisation tables (zigzag order) and the
// standard Huffman tables, which libjpeg's jpeg_set_defaults installs
const uint8_t kStdQuant[2][64] = {
    {16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17,  16,  19,  24, 40, 26, 24,  22, 22, 24, 49,
     35, 37, 29, 40, 58, 51, 61, 60, 57, 51, 56, 55,  64,  72,  92, 78, 64, 68,  87, 69, 55, 56,
     80, 109, 81, 87, 95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99},
    {17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};
const uint8_t kDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
                                {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
const uint8_t kAcVals[2][162] = {
    {1,   2,   3,   0,   4,   17,  5,   18,  33,  49,  65,  6,   19,  81,  97,  7,   34,  113, 20,  50,  129,
     145, 161, 8,   35,  66,  177, 193, 21,  82,  209, 240, 36,  51,  98,  114, 130, 9,   10,  22,  23,  24,
     25,  26,  37,  38,  39,  40,  41,  42,  52,  53,  54,  55,  56,  57,  58,  67,  68,  69,  70,  71,  72,
     73,  74,  83,  84,  85,  86,  87,  88,  89,  90,  99,  100, 101, 102, 103, 104, 105, 106, 115, 116, 117,
     118, 119, 120, 121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151, 152, 153,
     154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195,
     196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 225, 226, 227, 228, 229,
     230, 231, 232, 233, 234, 241, 242, 243, 244, 245, 246, 247, 248, 249, 250},
    {0,   1,   2,   3,   17,  4,   5,   33,  49,  6,   18,  65,  81,  7,   97,  113, 19,  34,  50,  129, 8,
     20,  66,  145, 161, 177, 193, 9,   35,  51,  82,  240, 21,  98,  114, 209, 10,  22,  36,  52,  225, 37,
     241, 23,  24,  25,  26,  38,  39,  40,  41,  42,  53,  54,  55,  56,  57,  58,  67,  68,  69,  70,  71,
     72,  73,  74,  83,  84,  85,  86,  87,  88,  89,  90,  99,  100, 101, 102, 103, 104, 105, 106, 115, 116,
     117, 118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151,
     152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186,
     194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 226, 227, 228,
     229, 230, 231, 232, 233, 234, 242, 243, 244, 245, 246, 247, 248, 249, 250}};

struct EncHuff {
  uint16_t code[256];
  uint8_t size[256];
};

EncHuff enc_huff(const uint8_t* bits, const uint8_t* vals) {
  EncHuff t{};
  int code = 0, p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int k = 0; k < bits[l - 1]; ++k, ++p, ++code) {
      t.code[vals[p]] = uint16_t(code);
      t.size[vals[p]] = uint8_t(l);
    }
    code <<= 1;
  }
  return t;
}

class BitOut {
 public:
  explicit BitOut(std::vector<uint8_t>* out) : out_(out) {}
  void put(uint32_t code, int size) {
    buf_ = (buf_ << size) | (code & ((1u << size) - 1));
    cnt_ += size;
    while (cnt_ >= 8) {
      uint8_t b = uint8_t(buf_ >> (cnt_ - 8));
      out_->push_back(b);
      if (b == 0xFF) out_->push_back(0);
      cnt_ -= 8;
    }
  }
  void flush() {
    if (cnt_) put(0x7F, 8 - cnt_);  // pad the last byte with ones
  }

 private:
  std::vector<uint8_t>* out_;
  uint64_t buf_ = 0;
  int cnt_ = 0;
};

// jfdctint.c: the accurate integer forward DCT, output scaled up by 8
void fdct_islow(int* data) {
  using namespace idct;
  for (int r = 0; r < 8; ++r) {
    int* p = data + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    p[2] = int(descale(z1 + tmp13 * F0_765, kConstBits - kPass1Bits));
    p[6] = int(descale(z1 + tmp12 * -F1_847, kConstBits - kPass1Bits));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp4 *= F0_298;
    tmp5 *= F2_053;
    tmp6 *= F3_072;
    tmp7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[7] = int(descale(tmp4 + z1 + z3, kConstBits - kPass1Bits));
    p[5] = int(descale(tmp5 + z2 + z4, kConstBits - kPass1Bits));
    p[3] = int(descale(tmp6 + z2 + z3, kConstBits - kPass1Bits));
    p[1] = int(descale(tmp7 + z1 + z4, kConstBits - kPass1Bits));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = data + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    p[16] = int(descale(z1 + tmp13 * F0_765, kConstBits + kPass1Bits));
    p[48] = int(descale(z1 + tmp12 * -F1_847, kConstBits + kPass1Bits));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp4 *= F0_298;
    tmp5 *= F2_053;
    tmp6 *= F3_072;
    tmp7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[56] = int(descale(tmp4 + z1 + z3, kConstBits + kPass1Bits));
    p[40] = int(descale(tmp5 + z2 + z4, kConstBits + kPass1Bits));
    p[24] = int(descale(tmp6 + z2 + z3, kConstBits + kPass1Bits));
    p[8] = int(descale(tmp7 + z1 + z4, kConstBits + kPass1Bits));
  }
}

// jcdctmgr.c compute_reciprocal / quantize: division by (q << 3), rounded, in 16 bits
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor, fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {uint32_t(fq & 0xFFFF), c & 0xFFFF, r};
}

std::vector<uint8_t> encode_jpeg(const uint8_t* rgb, int h, int w, int quality) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535) fail(kUnsupported);
  quality = std::clamp(quality, 1, 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qt[2][64];  // natural order
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int k = 0; k < 64; ++k) {
      long v = (long(kStdQuant[t][k]) * scale + 50) / 100;
      v = std::clamp(v, 1L, 255L);  // force_baseline
      qt[t][kZigzag[k]] = uint16_t(v);
    }
  for (int t = 0; t < 2; ++t)
    for (int k = 0; k < 64; ++k) div[t][k] = reciprocal(uint32_t(qt[t][k]) << 3);

  // jccolor.c rgb_ycc_convert
  const int64_t half = int64_t(1) << 15, cbcr = int64_t(128) << 16;
  auto fix = [](double x) { return int64_t(x * 65536 + 0.5); };
  size_t W = size_t(w), H = size_t(h);
  std::vector<uint8_t> Y(W * H), Cb(W * H), Cr(W * H);
  for (size_t i = 0; i < W * H; ++i) {
    int64_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    Y[i] = uint8_t((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16);
    Cb[i] = uint8_t((-fix(0.16874) * r - fix(0.33126) * g + fix(0.50000) * b + cbcr + half - 1) >> 16);
    Cr[i] = uint8_t((fix(0.50000) * r - fix(0.41869) * g - fix(0.08131) * b + cbcr + half - 1) >> 16);
  }
  int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  int ywib = (w + 7) / 8, yhib = (h + 7) / 8;
  // luma, edge-replicated to ywib * 8 columns and mcuy * 16 rows
  size_t yw = size_t(ywib) * 8, yh = size_t(mcuy) * 16;
  std::vector<uint8_t> yp(yw * yh);
  for (size_t y = 0; y < yh; ++y)
    for (size_t x = 0; x < yw; ++x) yp[y * yw + x] = Y[std::min(y, H - 1) * W + std::min(x, W - 1)];
  // chroma: replicated to an even row count and mcux * 16 columns, then
  // jcsample.c h2v2_downsample (bias 1, 2, 1, 2, ...), then rows replicated to mcuy * 8
  size_t cw = size_t(mcux) * 8, ch = size_t(mcuy) * 8, crows = (H + 1) / 2;
  std::vector<uint8_t> cb(cw * ch), cr(cw * ch);
  for (int k = 0; k < 2; ++k) {
    const std::vector<uint8_t>& src = k ? Cr : Cb;
    std::vector<uint8_t>& dst = k ? cr : cb;
    for (size_t oy = 0; oy < ch; ++oy) {
      size_t ry = std::min(oy, crows - 1);
      const uint8_t* r0 = src.data() + std::min(2 * ry, H - 1) * W;
      const uint8_t* r1 = src.data() + std::min(2 * ry + 1, H - 1) * W;
      int bias = 1;
      for (size_t ox = 0; ox < cw; ++ox) {
        size_t x0 = std::min(2 * ox, W - 1), x1 = std::min(2 * ox + 1, W - 1);
        dst[oy * cw + ox] = uint8_t((r0[x0] + r0[x1] + r1[x0] + r1[x1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  std::vector<uint8_t> out;
  out.reserve(W * H / 2 + 1024);
  auto put16 = [&](int v) {
    out.push_back(uint8_t(v >> 8));
    out.push_back(uint8_t(v & 0xFF));
  };
  auto marker = [&](int m, int len) {
    out.push_back(0xFF);
    out.push_back(uint8_t(m));
    put16(len);
  };
  out.push_back(0xFF);
  out.push_back(0xD8);
  marker(0xE0, 16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out.insert(out.end(), jfif, jfif + 14);
  for (int t = 0; t < 2; ++t) {
    marker(0xDB, 67);
    out.push_back(uint8_t(t));
    for (int k = 0; k < 64; ++k) out.push_back(uint8_t(qt[t][kZigzag[k]]));
  }
  marker(0xC0, 17);
  out.push_back(8);
  put16(h);
  put16(w);
  out.push_back(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  out.insert(out.end(), comps, comps + 9);
  for (int t = 0; t < 2; ++t) {
    marker(0xC4, 2 + 17 + 12);
    out.push_back(uint8_t(t));
    out.insert(out.end(), kDcBits[t], kDcBits[t] + 16);
    out.insert(out.end(), kDcVals, kDcVals + 12);
    marker(0xC4, 2 + 17 + 162);
    out.push_back(uint8_t(0x10 | t));
    out.insert(out.end(), kAcBits[t], kAcBits[t] + 16);
    out.insert(out.end(), kAcVals[t], kAcVals[t] + 162);
  }
  marker(0xDA, 12);
  const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  out.insert(out.end(), sos, sos + 10);

  static const EncHuff dc[2] = {enc_huff(kDcBits[0], kDcVals), enc_huff(kDcBits[1], kDcVals)};
  static const EncHuff ac[2] = {enc_huff(kAcBits[0], kAcVals[0]), enc_huff(kAcBits[1], kAcVals[1])};
  BitOut bits(&out);
  auto quantize = [&](const uint8_t* src, size_t stride, int t, int16_t* coef) {
    int ws[64];
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) ws[8 * r + c] = int(src[r * stride + c]) - 128;
    fdct_islow(ws);
    for (int k = 0; k < 64; ++k) {
      const Divisor& d = div[t][k];
      int v = ws[k];
      uint32_t a = uint32_t(v < 0 ? -v : v);
      int q = int(((a + d.corr) * d.recip) >> d.shift);
      coef[k] = int16_t(v < 0 ? -q : q);
    }
  };
  auto encode_block = [&](const int16_t* coef, int* last_dc, int t) {
    int diff = coef[0] - *last_dc;
    *last_dc = coef[0];
    int a = diff < 0 ? -diff : diff, v = diff < 0 ? diff - 1 : diff, nbits = 0;
    while (a) {
      ++nbits;
      a >>= 1;
    }
    bits.put(dc[t].code[nbits], dc[t].size[nbits]);
    if (nbits) bits.put(uint32_t(v), nbits);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int c = coef[kZigzag[k]];
      if (!c) {
        ++run;
        continue;
      }
      while (run > 15) {
        bits.put(ac[t].code[0xF0], ac[t].size[0xF0]);
        run -= 16;
      }
      a = c < 0 ? -c : c;
      v = c < 0 ? c - 1 : c;
      nbits = 1;
      while (a >>= 1) ++nbits;
      int sym = (run << 4) + nbits;
      bits.put(ac[t].code[sym], ac[t].size[sym]);
      bits.put(uint32_t(v), nbits);
      run = 0;
    }
    if (run) bits.put(ac[t].code[0], ac[t].size[0]);
  };
  int dc_y = 0, dc_cb = 0, dc_cr = 0;
  int last_col_width = ywib % 2 ? 1 : 2, last_row_height = yhib % 2 ? 1 : 2;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      int16_t blocks[4][64];
      int cnt = mx < mcux - 1 ? 2 : last_col_width;
      for (int yi = 0; yi < 2; ++yi) {  // jccoefct.c compress_data, dummy blocks included
        int16_t* row = blocks[2 * yi];
        if (my < mcuy - 1 || yi < last_row_height) {
          for (int bi = 0; bi < cnt; ++bi)
            quantize(&yp[(size_t(my) * 16 + size_t(yi) * 8) * yw + size_t(mx) * 16 + size_t(bi) * 8], yw, 0, row + 64 * bi);
          for (int bi = cnt; bi < 2; ++bi) {
            std::memset(row + 64 * bi, 0, 64 * sizeof(int16_t));
            row[64 * bi] = row[64 * (bi - 1)];
          }
        } else {
          int16_t prev_dc = blocks[2 * yi - 1][0];
          std::memset(row, 0, 2 * 64 * sizeof(int16_t));
          row[0] = row[64] = prev_dc;
        }
      }
      for (int b = 0; b < 4; ++b) encode_block(blocks[b], &dc_y, 0);
      int16_t cblock[64];
      quantize(&cb[size_t(my) * 8 * cw + size_t(mx) * 8], cw, 1, cblock);
      encode_block(cblock, &dc_cb, 1);
      quantize(&cr[size_t(my) * 8 * cw + size_t(mx) * 8], cw, 1, cblock);
      encode_block(cblock, &dc_cr, 1);
    }
  }
  bits.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

// ----------------------------------------------------------- batch loader

inline void sample_bilinear(const Image& src, float x, float y, float* px) {
  int x0 = int(std::floor(x)), y0 = int(std::floor(y));
  float fx = x - x0, fy = y - y0;
  for (int c = 0; c < 3; ++c) px[c] = 0.f;
  for (int dy = 0; dy < 2; ++dy) {
    int yy = y0 + dy;
    if (yy < 0 || yy >= src.h) continue;
    float wy = dy ? fy : 1.f - fy;
    for (int dx = 0; dx < 2; ++dx) {
      int xx = x0 + dx;
      if (xx < 0 || xx >= src.w) continue;
      float wxy = wy * (dx ? fx : 1.f - fx);
      const uint8_t* p = src.rgb.data() + (size_t(yy) * src.w + xx) * 3;
      for (int c = 0; c < 3; ++c) px[c] += wxy * p[c];
    }
  }
}

// One item: decode `path` (libpng's convention for PNG); warp with the
// forward affine `mat` (inverted, as cv2.warpAffine does) or resize pixel
// centres onto pixel centres when mat is null; (u8 - 127.5) / 127.5; flip.
// The native loader's load_one.
int load_one(const char* path, const float* mat, bool flip, int out_h, int out_w, float* out) {
  Image img;
  std::vector<uint8_t> bytes;
  if (!read_file(path, &bytes)) return kUnreadable;
  try {
    decode_any(bytes.data(), bytes.size(), kNative, &img);
  } catch (const Fail& f) {
    return f.status;
  } catch (const std::bad_alloc&) {
    return kUnsupported;
  }
  if (!mat && img.h == out_h && img.w == out_w) {
    const uint8_t* src = img.rgb.data();
    for (int y = 0; y < out_h; ++y) {
      const uint8_t* srow = src + size_t(y) * out_w * 3;
      float* drow = out + size_t(y) * out_w * 3;
      if (flip) {
        for (int x = 0; x < out_w; ++x) {
          const uint8_t* p = srow + size_t(out_w - 1 - x) * 3;
          float* d = drow + size_t(x) * 3;
          d[0] = (p[0] - 127.5f) / 127.5f;
          d[1] = (p[1] - 127.5f) / 127.5f;
          d[2] = (p[2] - 127.5f) / 127.5f;
        }
      } else {
        for (int k = 0; k < out_w * 3; ++k) drow[k] = (srow[k] - 127.5f) / 127.5f;
      }
    }
    return kOk;
  }
  float inv[6];
  if (mat) {
    float a = mat[0], b = mat[1], c = mat[2];
    float d = mat[3], e = mat[4], f = mat[5];
    float det = a * e - b * d;
    if (std::fabs(det) < 1e-12f) return kSingular;
    inv[0] = e / det;
    inv[1] = -b / det;
    inv[2] = (b * f - e * c) / det;
    inv[3] = -d / det;
    inv[4] = a / det;
    inv[5] = (d * c - a * f) / det;
  } else {
    float sx = float(img.w) / out_w, sy = float(img.h) / out_h;
    inv[0] = sx;
    inv[1] = 0.f;
    inv[2] = 0.5f * sx - 0.5f;
    inv[3] = 0.f;
    inv[4] = sy;
    inv[5] = 0.5f * sy - 0.5f;
  }
  for (int y = 0; y < out_h; ++y) {
    for (int x = 0; x < out_w; ++x) {
      float sxf = inv[0] * x + inv[1] * y + inv[2];
      float syf = inv[3] * x + inv[4] * y + inv[5];
      float px[3];
      sample_bilinear(img, sxf, syf, px);
      int ox = flip ? (out_w - 1 - x) : x;
      float* dst = out + (size_t(y) * out_w + ox) * 3;
      for (int c = 0; c < 3; ++c) dst[c] = (px[c] - 127.5f) / 127.5f;
    }
  }
  return kOk;
}

template <typename F>
int guarded(F&& body) {
  try {
    return body();
  } catch (const Fail& f) {
    return f.status;
  } catch (const std::bad_alloc&) {
    return kUnsupported;
  }
}

}  // namespace

extern "C" {

// Decode PNG or JPEG bytes to RGB u8. On success *out is a malloc'd
// h * w * 3 buffer the caller releases with fdio_free.
int fdio_decode(const uint8_t* data, size_t n, int convention, uint8_t** out, int* h, int* w) {
  *out = nullptr;
  return guarded([&] {
    Image img;
    decode_any(data, n, convention, &img);
    *out = static_cast<uint8_t*>(std::malloc(img.rgb.size()));
    if (!*out) return int(kUnsupported);
    std::memcpy(*out, img.rgb.data(), img.rgb.size());
    *h = img.h;
    *w = img.w;
    return int(kOk);
  });
}

// Encode h x w x 3 RGB u8 as a baseline 4:2:0 JPEG. *out as for fdio_decode.
int fdio_encode_jpeg(const uint8_t* rgb, int h, int w, int quality, uint8_t** out, size_t* n) {
  *out = nullptr;
  return guarded([&] {
    std::vector<uint8_t> bytes = encode_jpeg(rgb, h, w, quality);
    *out = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!*out) return int(kUnsupported);
    std::memcpy(*out, bytes.data(), bytes.size());
    *n = bytes.size();
    return int(kOk);
  });
}

void fdio_free(void* p) { std::free(p); }

// paths: n C strings. mats: null or [n, 6] f32 forward affines (an all-zero
// row: no warp). flips: null or [n] u8. out: [n, out_h, out_w, 3] f32.
// statuses: [n]. Returns the number of failed items.
int fdio_load_batch(const char** paths, int n, const float* mats, const uint8_t* flips, int out_h, int out_w,
                    int n_threads, float* out, int* statuses) {
  std::atomic<int> next(0), failures(0);
  size_t stride = size_t(out_h) * out_w * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const float* m = nullptr;
      if (mats) {
        const float* row = mats + size_t(i) * 6;
        bool nonzero = false;
        for (int k = 0; k < 6; ++k) nonzero |= (row[k] != 0.f);
        if (nonzero) m = row;
      }
      bool flip = flips && flips[i];
      int rc = load_one(paths[i], m, flip, out_h, out_w, out + stride * i);
      statuses[i] = rc;
      if (rc) failures.fetch_add(1);
    }
  };
  int hw = int(std::thread::hardware_concurrency());
  if (hw > 0 && n_threads > hw) n_threads = hw;
  int nt = n_threads < 1 ? 1 : (n_threads > n ? n : n_threads);
  std::vector<std::thread> threads;
  threads.reserve(size_t(nt));
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
