// Host-side decode and augmentation of PASCAL VOC samples, for the loader's
// worker processes (the port's copy of pixelssl_tpu/native/augment.cpp).
//
// The augmentation is the JAX package's, unchanged: one fused pass per
// sample of point-sampled bilinear resize + crop + horizontal flip (+
// ImageNet normalisation) from uint8 HWC into the float32 or uint8 batch
// slot, and a nearest-neighbour label resize into the int32 or int16 slot
// (augment.cpp:78-122 there). The extern "C" entry points keep that
// library's names and arguments, so one ctypes binding
// (pixelssl_tpu_torch/nn/native.py) drives either build.
//
// What differs is the decoding. The JAX library links libjpeg and libpng;
// the machines this port runs on need not have either (the H100 host has
// neither header), and nvJPEG, which ships with the CUDA toolkit, runs its
// IDCT on the card, which a loader worker forked after the main process
// set up CUDA cannot use. So this file carries its own decoders:
//
// * JPEG: baseline and extended sequential Huffman (SOF0/SOF1), 8-bit,
//   gray or YCbCr with 1x1, 2x1 or 2x2 chroma, restart markers. The
//   arithmetic is libjpeg's defaults, so that the pixels equal those of
//   libjpeg(-turbo), which Pillow uses: the accurate integer IDCT
//   (jidctint.c, 13-bit constants, 2 extra bits in the first pass),
//   "fancy" triangle-filter chroma upsampling (jdsample.c) and the
//   fixed-point YCbCr->RGB tables (jdcolor.c). Progressive, arithmetic-
//   coded, 12-bit, CMYK and other subsamplings are refused with an error.
// * PNG: 8-bit gray or palette, not interlaced, through zlib; the palette
//   index is the class id (VOC SegmentationClassAug). Other PNGs are refused.
//
// Errors never fall back: a function returns non-zero and
// pixelssl_augment_error() says why.
//
// Build: g++ -O3 -std=c++17 -fPIC -pthread -shared augment.cpp -lz
// (nn/native.py does it at first use).

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

thread_local std::string g_error;

bool fail(const std::string& msg) {
  g_error = msg;
  return false;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return fail(std::string("cannot open ") + path);
  fseek(f, 0, SEEK_END);
  const long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n > 0 ? n : 0);
  const size_t got = n > 0 ? fread(out->data(), 1, n, f) : 0;
  fclose(f);
  if (n <= 0 || got != static_cast<size_t>(n))
    return fail(std::string("cannot read ") + path);
  return true;
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};  // largest code of each length, -1 if none
  int32_t valptr[17] = {};
  int32_t mincode[17] = {};
  // the first kLookBits bits -> (length << 8 | value), 0 if longer
  uint16_t look[1 << kLookBits] = {};

  bool build(const uint8_t* counts, const uint8_t* symbols, int total) {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      k += counts[l - 1];
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) return fail("JPEG: bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    if (k != total) return fail("JPEG: bad Huffman table");
    memcpy(vals, symbols, total);
    memset(look, 0, sizeof(look));
    code = 0;
    k = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        const int shift = kLookBits - l;
        for (int j = 0; j < (1 << shift); ++j)
          look[(code << shift) | j] = static_cast<uint16_t>(l << 8 | vals[k]);
      }
      code <<= 1;
    }
    defined = true;
    return true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int pred = 0;
  int bw = 0, bh = 0;           // blocks a row and a column of the plane
  std::vector<uint8_t> plane;   // [bh * 8][bw * 8]
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

  // After a marker or the end of the data, zeros are fed, as libjpeg does.
  void fill() {
    while (nbits_ <= 56) {
      uint32_t byte = 0;
      if (!marker_ && pos_ < n_) {
        byte = d_[pos_];
        if (byte == 0xFF) {
          const uint8_t next = pos_ + 1 < n_ ? d_[pos_ + 1] : 0xD9;
          if (next == 0x00) {
            pos_ += 2;
          } else {
            marker_ = true;
            byte = 0;
          }
        } else {
          ++pos_;
        }
      }
      acc_ |= static_cast<uint64_t>(byte) << (56 - nbits_);
      nbits_ += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits_ < n) fill();
    return static_cast<uint32_t>(acc_ >> (64 - n));
  }
  void skip(int n) {
    acc_ <<= n;
    nbits_ -= n;
  }
  int bits(int n) {
    if (n == 0) return 0;
    const int v = static_cast<int>(peek(n));
    skip(n);
    return v;
  }
  // Decode one Huffman symbol; -1 on a code that is not in the table.
  int decode(const Huffman& t) {
    const uint32_t p = peek(16);
    const uint16_t e = t.look[p >> (16 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int32_t code = static_cast<int32_t>(p >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[t.valptr[l] + code - t.mincode[l]];
      }
    }
    return -1;
  }
  // Drop the buffered bits and step over the RSTn marker that follows.
  bool restart() {
    acc_ = 0;
    nbits_ = 0;
    marker_ = false;
    while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] >= 0xD0 &&
                              d_[pos_ + 1] <= 0xD7))
      ++pos_;
    if (pos_ + 1 >= n_) return fail("JPEG: missing restart marker");
    pos_ += 2;
    return true;
  }
  // Position of the next marker after the scan's data.
  size_t end() {
    size_t p = pos_;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 &&
                           !(d_[p + 1] >= 0xD0 && d_[p + 1] <= 0xD7)))
      ++p;
    return p;
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
  bool marker_ = false;
};

inline int extend(int v, int t) {
  return t == 0 ? 0 : (v < (1 << (t - 1)) ? v - (1 << t) + 1 : v);
}

// jidctint.c: the accurate integer inverse DCT (libjpeg's JDCT_ISLOW) of
// one dequantised block, into 8 rows of `out` at `stride`.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// the post-IDCT range limit: 10 bits of the value kept, then clamped
inline uint8_t idct_limit(int64_t x) {
  int v = static_cast<int>(x & 0x3FF);
  if (v >= 512) v -= 1024;
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int32_t* in, uint8_t* out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* p = in + c;
    int64_t* w = ws + c;
    if (!p[8] && !p[16] && !p[24] && !p[32] && !p[40] && !p[48] && !p[56]) {
      const int64_t dc = static_cast<int64_t>(p[0]) << kPass1Bits;
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = p[16], z3 = p[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = p[0];
    z3 = p[32];
    int64_t tmp0 = (z2 + z3) << kConstBits;
    int64_t tmp1 = (z2 - z3) << kConstBits;
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = p[56];
    tmp1 = p[40];
    tmp2 = p[24];
    tmp3 = p[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
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
    const int sh = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, sh);
    w[56] = descale(tmp10 - tmp3, sh);
    w[8] = descale(tmp11 + tmp2, sh);
    w[48] = descale(tmp11 - tmp2, sh);
    w[16] = descale(tmp12 + tmp1, sh);
    w[40] = descale(tmp12 - tmp1, sh);
    w[24] = descale(tmp13 + tmp0, sh);
    w[32] = descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int64_t* w = ws + r * 8;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (w[0] + w[4]) << kConstBits;
    int64_t tmp1 = (w[0] - w[4]) << kConstBits;
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
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
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, sh));
    o[7] = idct_limit(descale(tmp10 - tmp3, sh));
    o[1] = idct_limit(descale(tmp11 + tmp2, sh));
    o[6] = idct_limit(descale(tmp11 - tmp2, sh));
    o[2] = idct_limit(descale(tmp12 + tmp1, sh));
    o[5] = idct_limit(descale(tmp12 - tmp1, sh));
    o[3] = idct_limit(descale(tmp13 + tmp0, sh));
    o[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

struct Jpeg {
  int width = 0, height = 0;
  int hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool adobe_rgb = false;  // Adobe APP14 with transform 0: no YCbCr
  std::vector<Component> comps;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  bool frame = false;
};

inline int u16(const uint8_t* p) { return p[0] << 8 | p[1]; }

bool parse_frame(Jpeg* j, const uint8_t* p, int len) {
  if (len < 6) return fail("JPEG: short SOF");
  if (p[0] != 8) return fail("JPEG: only 8-bit samples are supported");
  j->height = u16(p + 1);
  j->width = u16(p + 3);
  const int nf = p[5];
  if (j->height <= 0 || j->width <= 0)
    return fail("JPEG: no image size in SOF");
  if (nf != 1 && nf != 3)
    return fail("JPEG: " + std::to_string(nf) +
                " components (only gray and YCbCr are supported)");
  if (len < 6 + 3 * nf) return fail("JPEG: short SOF");
  j->comps.resize(nf);
  for (int i = 0; i < nf; ++i) {
    Component& c = j->comps[i];
    c.id = p[6 + 3 * i];
    c.h = p[7 + 3 * i] >> 4;
    c.v = p[7 + 3 * i] & 15;
    c.tq = p[8 + 3 * i] & 3;
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
      return fail("JPEG: bad sampling factors");
    j->hmax = std::max(j->hmax, c.h);
    j->vmax = std::max(j->vmax, c.v);
  }
  j->mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
  j->mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
  for (Component& c : j->comps) {
    const int rx = j->hmax / c.h, ry = j->vmax / c.v;
    if (nf == 1) {
      c.h = c.v = 1;
      j->hmax = j->vmax = 1;
      j->mcux = (j->width + 7) / 8;
      j->mcuy = (j->height + 7) / 8;
    } else if (j->hmax % c.h || j->vmax % c.v || rx > 2 || ry > 2 ||
               (rx == 1 && ry == 2)) {
      return fail("JPEG: chroma subsampling other than 4:4:4, 4:2:2 and "
                  "4:2:0 is not supported");
    }
  }
  for (Component& c : j->comps) {
    c.bw = j->mcux * c.h;
    c.bh = j->mcuy * c.v;
    c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
  }
  j->frame = true;
  return true;
}

bool decode_block(BitReader* br, const Jpeg& j, Component* c, uint8_t* out,
                  int stride) {
  int32_t coef[64] = {};
  const uint16_t* q = j.qt[c->tq];
  const int t = br->decode(j.dc[c->td]);
  if (t < 0 || t > 11) return fail("JPEG: bad DC code");
  c->pred += extend(br->bits(t), t);
  coef[0] = c->pred * q[0];
  for (int k = 1; k < 64;) {
    const int rs = br->decode(j.ac[c->ta]);
    if (rs < 0) return fail("JPEG: bad AC code");
    const int r = rs >> 4, s = rs & 15;
    if (s == 0) {
      if (r != 15) break;
      k += 16;
      continue;
    }
    k += r;
    if (k > 63) return fail("JPEG: AC index past the block");
    coef[kZigzag[k]] = extend(br->bits(s), s) * q[k];
    ++k;
  }
  idct_islow(coef, out, stride);
  return true;
}

// One scan: interleaved (every component's blocks of an MCU in turn) or,
// with one component, that component's blocks in raster order.
bool decode_scan(Jpeg* j, const uint8_t* d, size_t n, size_t* pos,
                 const std::vector<int>& scomp) {
  BitReader br(d, n, *pos);
  for (int ci : scomp) {
    const Component& c = j->comps[ci];
    if (!j->dc[c.td].defined || !j->ac[c.ta].defined ||
        !j->qt_defined[c.tq])
      return fail("JPEG: scan uses an undefined table");
    j->comps[ci].pred = 0;
  }
  const bool single = scomp.size() == 1;
  int units_x, units_y;
  if (single) {
    const Component& c = j->comps[scomp[0]];
    units_x = (((j->width * c.h + j->hmax - 1) / j->hmax) + 7) / 8;
    units_y = (((j->height * c.v + j->vmax - 1) / j->vmax) + 7) / 8;
  } else {
    units_x = j->mcux;
    units_y = j->mcuy;
  }
  int todo = j->restart_interval;
  for (int uy = 0; uy < units_y; ++uy) {
    for (int ux = 0; ux < units_x; ++ux) {
      if (j->restart_interval) {
        if (todo == 0) {
          if (!br.restart()) return false;
          for (int ci : scomp) j->comps[ci].pred = 0;
          todo = j->restart_interval;
        }
        --todo;
      }
      for (int ci : scomp) {
        Component& c = j->comps[ci];
        const int stride = c.bw * 8;
        const int nh = single ? 1 : c.h, nv = single ? 1 : c.v;
        for (int by = 0; by < nv; ++by)
          for (int bx = 0; bx < nh; ++bx) {
            const int row = (uy * nv + by) * 8, col = (ux * nh + bx) * 8;
            if (!decode_block(&br, *j, &c,
                              c.plane.data() +
                                  static_cast<size_t>(row) * stride + col,
                              stride))
              return false;
          }
      }
    }
  }
  *pos = br.end();
  return true;
}

bool parse_jpeg(const uint8_t* d, size_t n, Jpeg* j, bool header_only) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return fail("not a JPEG file");
  size_t pos = 2;
  bool scanned = false;
  while (pos + 4 <= n) {
    if (d[pos] != 0xFF) {
      ++pos;
      continue;
    }
    const int m = d[pos + 1];
    if (m == 0xFF) {
      ++pos;
      continue;
    }
    pos += 2;
    if (m == 0xD9) break;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    const int len = u16(d + pos);
    if (len < 2 || pos + len > n) return fail("JPEG: truncated segment");
    const uint8_t* p = d + pos + 2;
    const int plen = len - 2;
    if (m == 0xC0 || m == 0xC1) {
      if (!parse_frame(j, p, plen)) return false;
      if (header_only) return true;
    } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      return fail(m == 0xC2 ? "JPEG: progressive JPEG is not supported"
                            : "JPEG: only baseline/sequential Huffman "
                              "JPEG is supported");
    } else if (m == 0xC4) {
      for (int q = 0; q + 17 <= plen;) {
        const int tc = p[q] >> 4, th = p[q] & 15;
        int total = 0;
        for (int l = 0; l < 16; ++l) total += p[q + 1 + l];
        if (th > 3 || tc > 1 || total > 256 || q + 17 + total > plen)
          return fail("JPEG: bad DHT");
        Huffman& t = tc ? j->ac[th] : j->dc[th];
        if (!t.build(p + q + 1, p + q + 17, total)) return false;
        q += 17 + total;
      }
    } else if (m == 0xDB) {
      for (int q = 0; q < plen;) {
        const int pq = p[q] >> 4, tq = p[q] & 15;
        if (tq > 3 || pq > 1 || q + 1 + 64 * (pq + 1) > plen)
          return fail("JPEG: bad DQT");
        for (int k = 0; k < 64; ++k)
          j->qt[tq][k] = pq ? u16(p + q + 1 + 2 * k) : p[q + 1 + k];
        j->qt_defined[tq] = true;
        q += 1 + 64 * (pq + 1);
      }
    } else if (m == 0xDD) {
      if (plen < 2) return fail("JPEG: bad DRI");
      j->restart_interval = u16(p);
    } else if (m == 0xEE) {
      if (plen >= 12 && memcmp(p, "Adobe", 5) == 0) j->adobe_rgb = p[11] == 0;
    } else if (m == 0xDA) {
      if (!j->frame) return fail("JPEG: scan before frame");
      const int ns = plen > 0 ? p[0] : 0;
      if (ns < 1 || plen < 1 + 2 * ns + 3) return fail("JPEG: bad SOS");
      std::vector<int> scomp;
      for (int i = 0; i < ns; ++i) {
        const int cid = p[1 + 2 * i];
        int ci = -1;
        for (size_t k = 0; k < j->comps.size(); ++k)
          if (j->comps[k].id == cid) ci = static_cast<int>(k);
        if (ci < 0) return fail("JPEG: scan names an unknown component");
        j->comps[ci].td = p[2 + 2 * i] >> 4;
        j->comps[ci].ta = p[2 + 2 * i] & 15;
        if (j->comps[ci].td > 3 || j->comps[ci].ta > 3)
          return fail("JPEG: bad SOS table");
        scomp.push_back(ci);
      }
      pos += len;
      if (!decode_scan(j, d, n, &pos, scomp)) return false;
      scanned = true;
      continue;
    }
    pos += len;
  }
  if (!j->frame) return fail("JPEG: no SOF0/SOF1 frame");
  if (!header_only && !scanned) return fail("JPEG: no scan");
  return true;
}

// jdsample.c's fancy upsampling of one component plane to full width
// (2x1) or full width and height (2x2); `w`, `h`: its downsampled size.
void upsample_h2v1(const uint8_t* in, int stride, int w, int h,
                   std::vector<uint8_t>* out, int ow) {
  out->assign(static_cast<size_t>(ow) * h, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* r = in + static_cast<size_t>(y) * stride;
    uint8_t* o = out->data() + static_cast<size_t>(y) * ow;
    if (w <= 2) {
      for (int x = 0; x < ow; ++x) o[x] = r[std::min(x / 2, w - 1)];
      continue;
    }
    int q = 0;
    o[q++] = r[0];
    o[q++] = static_cast<uint8_t>((r[0] * 3 + r[1] + 2) >> 2);
    for (int x = 1; x < w - 1; ++x) {
      const int v = r[x] * 3;
      o[q++] = static_cast<uint8_t>((v + r[x - 1] + 1) >> 2);
      o[q++] = static_cast<uint8_t>((v + r[x + 1] + 2) >> 2);
    }
    o[q++] = static_cast<uint8_t>((r[w - 1] * 3 + r[w - 2] + 1) >> 2);
    o[q++] = r[w - 1];
  }
}

void upsample_h2v2(const uint8_t* in, int stride, int w, int h,
                   std::vector<uint8_t>* out, int ow, int oh) {
  out->assign(static_cast<size_t>(ow) * oh, 0);
  for (int oy = 0; oy < oh; ++oy) {
    const int y = oy / 2;
    // the nearer neighbouring row, the edge row repeated past the edges
    const int yn = oy % 2 == 0 ? std::max(y - 1, 0) : std::min(y + 1, h - 1);
    const uint8_t* r0 = in + static_cast<size_t>(y) * stride;
    const uint8_t* r1 = in + static_cast<size_t>(yn) * stride;
    uint8_t* o = out->data() + static_cast<size_t>(oy) * ow;
    if (w <= 2) {
      for (int x = 0; x < ow; ++x) o[x] = r0[std::min(x / 2, w - 1)];
      continue;
    }
    int q = 0;
    int this_sum = r0[0] * 3 + r1[0];
    int next_sum = r0[1] * 3 + r1[1];
    o[q++] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
    o[q++] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int x = 2; x < w; ++x) {
      next_sum = r0[x] * 3 + r1[x];
      o[q++] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      o[q++] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    o[q++] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    o[q++] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
  }
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Decode a JPEG file to uint8 RGB [h, w, 3]; a gray file gives three equal
// channels (libjpeg's gray->RGB, and PIL's convert('RGB')).
bool decode_jpeg(const char* path, std::vector<uint8_t>* rgb, int* h,
                 int* w) {
  std::vector<uint8_t> data;
  if (!read_file(path, &data)) return false;
  Jpeg j;
  if (!parse_jpeg(data.data(), data.size(), &j, false))
    return fail(g_error + " (" + path + ")");
  *h = j.height;
  *w = j.width;
  const size_t npix = static_cast<size_t>(j.width) * j.height;
  rgb->resize(npix * 3);
  // every component at full size, each a [height][width] plane view
  std::vector<std::vector<uint8_t>> full(j.comps.size());
  std::vector<const uint8_t*> src(j.comps.size());
  std::vector<int> stride(j.comps.size());
  for (size_t ci = 0; ci < j.comps.size(); ++ci) {
    const Component& c = j.comps[ci];
    const int rx = j.hmax / c.h, ry = j.vmax / c.v;
    const int dw = (j.width * c.h + j.hmax - 1) / j.hmax;
    const int dh = (j.height * c.v + j.vmax - 1) / j.vmax;
    if (rx == 1 && ry == 1) {
      src[ci] = c.plane.data();
      stride[ci] = c.bw * 8;
    } else {
      if (rx == 2 && ry == 1)
        upsample_h2v1(c.plane.data(), c.bw * 8, dw, dh, &full[ci], 2 * dw);
      else
        upsample_h2v2(c.plane.data(), c.bw * 8, dw, dh, &full[ci], 2 * dw,
                      2 * dh);
      src[ci] = full[ci].data();
      stride[ci] = 2 * dw;
    }
  }
  if (j.comps.size() == 1) {
    for (int y = 0; y < j.height; ++y)
      for (int x = 0; x < j.width; ++x) {
        const uint8_t v = src[0][static_cast<size_t>(y) * stride[0] + x];
        uint8_t* o = rgb->data() + (static_cast<size_t>(y) * j.width + x) * 3;
        o[0] = o[1] = o[2] = v;
      }
    return true;
  }
  // jdcolor.c: R = Y + 1.402 Cr, G = Y - 0.34414 Cb - 0.71414 Cr,
  // B = Y + 1.772 Cb, in 16-bit fixed point with its rounding
  constexpr int kScale = 16;
  constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
  auto fix = [](double x) {
    return static_cast<int64_t>(x * (1 << kScale) + 0.5);
  };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  for (int y = 0; y < j.height; ++y) {
    const uint8_t* p0 = src[0] + static_cast<size_t>(y) * stride[0];
    const uint8_t* p1 = src[1] + static_cast<size_t>(y) * stride[1];
    const uint8_t* p2 = src[2] + static_cast<size_t>(y) * stride[2];
    uint8_t* o = rgb->data() + static_cast<size_t>(y) * j.width * 3;
    for (int x = 0; x < j.width; ++x, o += 3) {
      if (j.adobe_rgb) {
        o[0] = p0[x];
        o[1] = p1[x];
        o[2] = p2[x];
        continue;
      }
      const int yy = p0[x], cb = p1[x], cr = p2[x];
      o[0] = clamp255(yy + cr_r[cr]);
      o[1] = clamp255(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale));
      o[2] = clamp255(yy + cb_b[cb]);
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// PNG (8-bit gray or palette, not interlaced)
// ---------------------------------------------------------------------------

inline uint32_t be32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) << 24 | p[1] << 16 | p[2] << 8 | p[3];
}

bool decode_png_label(const char* path, std::vector<int32_t>* out, int* h,
                      int* w) {
  std::vector<uint8_t> d;
  if (!read_file(path, &d)) return false;
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (d.size() < 8 || memcmp(d.data(), kSig, 8) != 0)
    return fail(std::string("not a PNG file: ") + path);
  std::vector<uint8_t> idat;
  bool header = false;
  for (size_t pos = 8; pos + 12 <= d.size();) {
    const uint32_t len = be32(&d[pos]);
    if (pos + 12 + len > d.size())
      return fail(std::string("PNG: truncated chunk in ") + path);
    const uint8_t* type = &d[pos + 4];
    const uint8_t* p = &d[pos + 8];
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return fail("PNG: bad IHDR");
      *w = static_cast<int>(be32(p));
      *h = static_cast<int>(be32(p + 4));
      const int depth = p[8], color = p[9], interlace = p[12];
      if (depth != 8 || (color != 0 && color != 3) || interlace != 0)
        return fail(std::string("PNG: only 8-bit gray or palette, not "
                                "interlaced, label maps are supported "
                                "(bit depth ") +
                    std::to_string(depth) + ", color type " +
                    std::to_string(color) + ", interlace " +
                    std::to_string(interlace) + "): " + path);
      header = true;
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), p, p + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (!header || *w <= 0 || *h <= 0)
    return fail(std::string("PNG: no IHDR in ") + path);
  const size_t row = static_cast<size_t>(*w) + 1;
  std::vector<uint8_t> raw(row * *h);
  uLongf got = raw.size();
  if (uncompress(raw.data(), &got, idat.data(), idat.size()) != Z_OK ||
      got != raw.size())
    return fail(std::string("PNG: bad image data in ") + path);
  out->resize(static_cast<size_t>(*w) * *h);
  std::vector<uint8_t> prev(*w, 0), cur(*w);
  for (int y = 0; y < *h; ++y) {
    const uint8_t ft = raw[y * row];
    const uint8_t* f = &raw[y * row + 1];
    for (int x = 0; x < *w; ++x) {
      const int a = x ? cur[x - 1] : 0, b = prev[x], c = x ? prev[x - 1] : 0;
      int v = f[x];
      switch (ft) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) >> 1; break;
        case 4: {
          const int pp = a + b - c, pa = std::abs(pp - a),
                    pb = std::abs(pp - b), pc = std::abs(pp - c);
          v += (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default:
          return fail(std::string("PNG: bad filter type in ") + path);
      }
      cur[x] = static_cast<uint8_t>(v);
      (*out)[static_cast<size_t>(y) * *w + x] = cur[x];
    }
    std::swap(prev, cur);
  }
  return true;
}

// ---------------------------------------------------------------------------
// augmentation (pixelssl_tpu/native/augment.cpp:37-122, unchanged)
// ---------------------------------------------------------------------------

inline float lerp(float a, float b, float t) { return a + (b - a) * t; }

// Bilinear sample from uint8 HWC image (channels = 3), PIL-convention
// half-pixel centers (align_corners=false).
inline void sample_bilinear(const uint8_t* img, int h, int w, float sy,
                            float sx, float* out3) {
  sy = std::min(std::max(sy, 0.0f), static_cast<float>(h - 1));
  sx = std::min(std::max(sx, 0.0f), static_cast<float>(w - 1));
  const int y0 = static_cast<int>(sy), x0 = static_cast<int>(sx);
  const int y1 = std::min(y0 + 1, h - 1), x1 = std::min(x0 + 1, w - 1);
  const float ty = sy - y0, tx = sx - x0;
  for (int c = 0; c < 3; ++c) {
    const float v00 = img[(y0 * w + x0) * 3 + c];
    const float v01 = img[(y0 * w + x1) * 3 + c];
    const float v10 = img[(y1 * w + x0) * 3 + c];
    const float v11 = img[(y1 * w + x1) * 3 + c];
    out3[c] = lerp(lerp(v00, v01, tx), lerp(v10, v11, tx), ty);
  }
}

struct AugmentJob {
  const uint8_t* image;   // [h, w, 3]
  const int32_t* label;   // [h, w] or nullptr
  int h, w;
  int rh, rw, cy, cx, crop;  // resize to (rh, rw), crop at (cy, cx)
  int flip;
  int label_fill;         // label of padded (and unlabeled) pixels
  float* out_image;       // [crop, crop, 3] normalised float32
  int32_t* out_label;     // [crop, crop]
  // uint8 mode: rounded uint8 RGB (pad 0) + int16 labels instead
  uint8_t* out_image_u8 = nullptr;
  int16_t* out_label_i16 = nullptr;
};

const float kMean[3] = {0.485f, 0.456f, 0.406f};
const float kStd[3] = {0.229f, 0.224f, 0.225f};

void run_job(const AugmentJob& j) {
  const float sy_scale = static_cast<float>(j.h) / static_cast<float>(j.rh);
  const float sx_scale = static_cast<float>(j.w) / static_cast<float>(j.rw);
  const bool raw = j.out_image_u8 != nullptr;
  for (int y = 0; y < j.crop; ++y) {
    const int ry = y + j.cy;
    for (int x = 0; x < j.crop; ++x) {
      const int rx = x + j.cx;
      const int ox = j.flip ? (j.crop - 1 - x) : x;
      const size_t o = static_cast<size_t>(y) * j.crop + ox;
      if (ry < 0 || ry >= j.rh || rx < 0 || rx >= j.rw) {
        if (raw) {
          for (int c = 0; c < 3; ++c) j.out_image_u8[o * 3 + c] = 0;
          j.out_label_i16[o] = static_cast<int16_t>(j.label_fill);
        } else {
          for (int c = 0; c < 3; ++c)
            j.out_image[o * 3 + c] = (0.0f - kMean[c]) / kStd[c];
          j.out_label[o] = j.label_fill;
        }
        continue;
      }
      const float sy = (ry + 0.5f) * sy_scale - 0.5f;
      const float sx = (rx + 0.5f) * sx_scale - 0.5f;
      float rgb[3];
      sample_bilinear(j.image, j.h, j.w, sy, sx, rgb);
      int32_t lb = j.label_fill;
      if (j.label) {
        const int ny = std::min(j.h - 1, std::max(0, static_cast<int>(sy + 0.5f)));
        const int nx = std::min(j.w - 1, std::max(0, static_cast<int>(sx + 0.5f)));
        lb = j.label[ny * j.w + nx];
      }
      if (raw) {
        for (int c = 0; c < 3; ++c)
          j.out_image_u8[o * 3 + c] = static_cast<uint8_t>(
              std::min(255.0f, std::max(0.0f, rgb[c] + 0.5f)));
        j.out_label_i16[o] = static_cast<int16_t>(lb);
      } else {
        for (int c = 0; c < 3; ++c)
          j.out_image[o * 3 + c] = (rgb[c] / 255.0f - kMean[c]) / kStd[c];
        j.out_label[o] = lb;
      }
    }
  }
}

// decode_augment_sample's two forms: decode, then one job
int decode_and_run(const char* image_path, const char* label_path,
                   AugmentJob j) {
  std::vector<uint8_t> img;
  int h = 0, w = 0;
  if (!decode_jpeg(image_path, &img, &h, &w)) return 1;
  std::vector<int32_t> lbl;
  int lh = 0, lw = 0;
  if (label_path != nullptr) {
    if (!decode_png_label(label_path, &lbl, &lh, &lw)) return 2;
    if (lh != h || lw != w) {
      fail(std::string("label size differs from the image's: ") + label_path);
      return 3;
    }
  }
  j.image = img.data();
  j.label = label_path ? lbl.data() : nullptr;
  j.h = h;
  j.w = w;
  run_job(j);
  return 0;
}

}  // namespace

extern "C" {

// Why the last call of this thread returned non-zero.
const char* pixelssl_augment_error() { return g_error.c_str(); }

// (h, w) from the JPEG's frame header, without decoding the scan.
int jpeg_dims(const char* path, int32_t* h, int32_t* w) {
  std::vector<uint8_t> data;
  if (!read_file(path, &data)) return 1;
  Jpeg j;
  if (!parse_jpeg(data.data(), data.size(), &j, true)) {
    fail(g_error + " (" + path + ")");
    return 1;
  }
  *h = j.height;
  *w = j.width;
  return 0;
}

// Decode a JPEG into the caller's uint8 [h, w, 3] buffer (h, w from
// jpeg_dims). Returns 0 on success.
int decode_jpeg_rgb(const char* path, uint8_t* out, int h, int w) {
  std::vector<uint8_t> rgb;
  int dh = 0, dw = 0;
  if (!decode_jpeg(path, &rgb, &dh, &dw)) return 1;
  if (dh != h || dw != w) {
    fail(std::string("JPEG size differs from the buffer's: ") + path);
    return 2;
  }
  memcpy(out, rgb.data(), rgb.size());
  return 0;
}

// Decode (JPEG image + optional PNG label) and augment one sample straight
// into the caller's crop-sized slots. Non-zero on failure.
int decode_augment_sample(const char* image_path, const char* label_path,
                          int resize_h, int resize_w, int crop_y, int crop_x,
                          int flip, int label_fill, int crop_size,
                          float* out_image, int32_t* out_label) {
  AugmentJob j{nullptr, nullptr, 0, 0, resize_h, resize_w, crop_y, crop_x,
               crop_size, flip, label_fill, out_image, out_label};
  return decode_and_run(image_path, label_path, j);
}

// The uint8 form of decode_augment_sample: uint8 RGB + int16 labels.
int decode_augment_sample_raw(const char* image_path, const char* label_path,
                              int resize_h, int resize_w, int crop_y,
                              int crop_x, int flip, int label_fill,
                              int crop_size, uint8_t* out_image_u8,
                              int16_t* out_label_i16) {
  AugmentJob j{nullptr, nullptr, 0, 0, resize_h, resize_w, crop_y, crop_x,
               crop_size, flip, label_fill, nullptr, nullptr,
               out_image_u8, out_label_i16};
  return decode_and_run(image_path, label_path, j);
}

// Augment a batch of decoded images; per-sample geometry in the int arrays.
int augment_batch(const uint8_t** images, const int32_t** labels,
                  const int32_t* heights, const int32_t* widths,
                  const int32_t* resize_h, const int32_t* resize_w,
                  const int32_t* crop_y, const int32_t* crop_x,
                  const int32_t* flips, const int32_t* label_fills,
                  int batch, int crop_size, float* out_images,
                  int32_t* out_labels, int n_threads) {
  std::vector<AugmentJob> jobs(batch);
  for (int i = 0; i < batch; ++i) {
    jobs[i] = AugmentJob{
        images[i], labels ? labels[i] : nullptr, heights[i], widths[i],
        resize_h[i], resize_w[i], crop_y[i], crop_x[i], crop_size, flips[i],
        label_fills[i],
        out_images + static_cast<size_t>(i) * crop_size * crop_size * 3,
        out_labels + static_cast<size_t>(i) * crop_size * crop_size};
  }
  if (n_threads <= 1 || batch == 1) {
    for (auto& j : jobs) run_job(j);
    return 0;
  }
  std::atomic<int> counter(0);
  std::vector<std::thread> pool;
  const int workers = std::min(n_threads, batch);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&jobs, &counter, batch]() {
      for (int i = counter.fetch_add(1); i < batch; i = counter.fetch_add(1))
        run_job(jobs[i]);
    });
  }
  for (auto& th : pool) th.join();
  return 0;
}

// The uint8 form of augment_batch, one thread.
int augment_batch_raw(const uint8_t** images, const int32_t** labels,
                      const int32_t* heights, const int32_t* widths,
                      const int32_t* resize_h, const int32_t* resize_w,
                      const int32_t* crop_y, const int32_t* crop_x,
                      const int32_t* flips, const int32_t* label_fills,
                      int batch, int crop_size, uint8_t* out_images_u8,
                      int16_t* out_labels_i16) {
  for (int i = 0; i < batch; ++i) {
    AugmentJob j{
        images[i], labels ? labels[i] : nullptr, heights[i], widths[i],
        resize_h[i], resize_w[i], crop_y[i], crop_x[i], crop_size, flips[i],
        label_fills[i], nullptr, nullptr,
        out_images_u8 + static_cast<size_t>(i) * crop_size * crop_size * 3,
        out_labels_i16 + static_cast<size_t>(i) * crop_size * crop_size};
    run_job(j);
  }
  return 0;
}

}  // extern "C"
