// JPEG decode -> crop -> resize -> (optional) normalize in one GIL-free call,
// with the decoder itself in this file: no libjpeg is linked.
//
// The decoder reads baseline and extended sequential and progressive Huffman
// streams (SOF0, SOF1, SOF2; 8-bit samples) of one component (grayscale)
// or three (YCbCr, or RGB by an Adobe marker or the component ids), with
// any integer sampling factors and restart intervals.  To give the bytes
// Pillow's decode gives (libjpeg-turbo with its defaults), it repeats
// libjpeg's arithmetic:
//   * the integer "islow" IDCT (jidctint.c: 13-bit constants, 2 extra bits
//     in the first pass, the post-IDCT range limit of jdmaster.c);
//   * chroma upsampling (jdsample.c): the fancy triangle filters h2v1,
//     h1v2 and h2v2 (h2v2's vertical neighbour from the row above or below,
//     the image's first and last real rows repeated at its edges), and the
//     plain box replication where the fancy filter does not apply (a
//     component at most 2 samples wide, other ratios);
//   * the fixed-point YCbCr->RGB conversion of jdcolor.c (16-bit tables).
// Decoding runs into a coefficient buffer per component (the progressive
// scans refine it: DC first and refine, AC first with end-of-band runs, AC
// refine; jdphuff.c's rules), then the IDCT, upsampling and colour
// conversion over the whole image.  A stream that ends early decodes soft,
// as libjpeg does: the bits past the end read as zeros, and once they have
// been needed the remaining blocks stay zero (a mid-grey tile).  CMYK and
// YCCK (four components) return 2, so that the caller decodes the image
// another way; a stream this decoder does not read (lossless, arithmetic
// coding, 12-bit samples, a corrupt header) returns 1.
//
// Reduced-scale decoding (allow_dct_scale, the smallest M/8 of 1/8, 2/8 and
// 4/8 that keeps the crop at least the target size): each block's M x M
// outputs are the M-point inverse DCT of its M x M lowest coefficients
// (floating point, rounded once), the same sum the 8-point IDCT takes over
// all 64 at M = 8; the chroma planes are upsampled at that scale as at the
// full one (the box replication at M = 1, as libjpeg's 1x1 blocks get).
//
// After the decode: the crop, then Pillow-compatible convolution resampling
// (bicubic a = -0.5, the support widened when downscaling, 8-bit fixed-point
// accumulation with Pillow's rounding), horizontal then vertical, the
// channels planar; optionally (x / 255 - mean) / std into float32 CHW.  At
// full scale the result equals PIL's decode, crop and resize(BICUBIC) bit
// for bit.
//
// Error codes: 0 ok; 1 not a JPEG this decoder reads, or corrupt; 2 CMYK /
// YCCK.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- the stream ----------------------------------------------------------

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    // past the end: a corrupt run lands on 63, as jpeg_natural_order's pad
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {0};
  int maxcode[18] = {0};  // largest code of each length, -1 when none
  int valoff[17] = {0};   // vals index of the first code of a length, minus that code
  uint16_t fast[512];     // 9-bit lookahead: (length << 8) | value, 0 when longer
  bool build(const uint8_t* counts, const uint8_t* values, int nvals) {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += counts[l - 1];
    if (total > 256 || total != nvals) return false;
    std::memcpy(vals, values, nvals);
    int code = 0, k = 0;
    std::fill(fast, fast + 512, 0);
    for (int l = 1; l <= 16; ++l) {
      valoff[l] = k - code;
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        if (l <= 9) {
          const int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j)
            fast[(code << shift) | j] = static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) return false;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
    return true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;   // the scan's DC and AC tables
  int bw = 0, bh = 0;   // blocks of the coefficient buffer (whole MCUs)
  int cbw = 0, cbh = 0; // blocks that hold samples of the image
  int dw = 0, dh = 0;   // samples (downsampled width and height)
  int pred = 0;
  std::vector<int16_t> coef;  // [bh][bw][64], natural order
};

struct Decoder {
  const uint8_t* data;
  size_t len, pos = 0;
  int W = 0, H = 0, ncomp = 0, hmax = 1, vmax = 1, mcusx = 0, mcusy = 0;
  bool progressive = false, frame = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1, restart = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];
  // the entropy-coded segment
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;  // the next bytes are a marker or the end
  int zero_bits = 0;        // bits read past it, as zeros
  bool insufficient = false;
  int eobrun = 0;

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {}

  int byte() { return pos < len ? data[pos++] : -1; }
  int u16() {
    const int a = byte(), b = byte();
    return (a < 0 || b < 0) ? -1 : (a << 8) | b;
  }

  void reset_bits() {
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
    zero_bits = 0;
  }

  void fill() {
    while (bitcnt <= 24) {
      int b = 0;
      if (!hit_marker) {
        if (pos >= len) {
          hit_marker = true;
        } else if (data[pos] == 0xFF) {
          size_t p = pos + 1;
          while (p < len && data[p] == 0xFF) ++p;  // fill bytes
          if (p < len && data[p] == 0x00) {
            b = 0xFF;
            pos = p + 1;
          } else {
            hit_marker = true;  // pos stays at the marker
          }
        } else {
          b = data[pos++];
        }
      }
      if (hit_marker) zero_bits += 8;
      bitbuf |= static_cast<uint32_t>(b) << (24 - bitcnt);
      bitcnt += 8;
    }
  }

  // bits taken past the end of the segment make the data insufficient
  void note_use() {
    if (hit_marker && zero_bits > bitcnt) insufficient = true;
  }

  int bits(int n) {
    if (n == 0) return 0;
    if (bitcnt < n) fill();
    const int v = static_cast<int>(bitbuf >> (32 - n));
    bitbuf <<= n;
    bitcnt -= n;
    note_use();
    return v;
  }
  int bit() { return bits(1); }

  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  // -1 on a code no table has
  int decode(const Huffman& t) {
    if (bitcnt < 16) fill();
    const uint16_t f = t.fast[bitbuf >> 23];
    if (f) {
      const int l = f >> 8;
      bitbuf <<= l;
      bitcnt -= l;
      note_use();
      return f & 0xFF;
    }
    int code = 0;
    for (int l = 1; l <= 16; ++l) {
      code = (code << 1) | static_cast<int>(bitbuf >> 31);
      bitbuf <<= 1;
      --bitcnt;
      if (code <= t.maxcode[l]) {
        note_use();
        return t.vals[t.valoff[l] + code];
      }
    }
    note_use();
    return -1;
  }

  // ---- markers ----

  bool read_dqt(int n) {
    const size_t end = pos + n;
    while (pos < end) {
      const int pq = byte();
      if (pq < 0 || (pq & 15) > 3) return false;
      const int t = pq & 15;
      for (int i = 0; i < 64; ++i) {
        const int v = (pq >> 4) ? u16() : byte();
        if (v < 0) return false;
        qt[t][kZigzag[i]] = static_cast<uint16_t>(v);
      }
      qt_defined[t] = true;
    }
    return pos == end;
  }

  bool read_dht(int n) {
    const size_t end = pos + n;
    while (pos < end) {
      const int tc = byte();
      if (tc < 0 || (tc & 15) > 3 || (tc >> 4) > 1) return false;
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        const int c = byte();
        if (c < 0) return false;
        counts[i] = static_cast<uint8_t>(c);
        total += c;
      }
      if (total > 256 || pos + total > len) return false;
      Huffman& t = (tc >> 4) ? ac[tc & 15] : dc[tc & 15];
      if (!t.build(counts, data + pos, total)) return false;
      pos += total;
    }
    return pos == end;
  }

  bool read_sof(int n, int marker) {
    if (frame || n < 6) return false;
    const int P = byte();
    H = u16();
    W = u16();
    ncomp = byte();
    if (P != 8 || H <= 0 || W <= 0 || ncomp <= 0 || ncomp > 4 || n != 6 + 3 * ncomp)
      return false;
    progressive = marker == 0xC2;
    for (int c = 0; c < ncomp; ++c) {
      comp[c].id = byte();
      const int hv = byte();
      comp[c].tq = byte();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4 || comp[c].tq > 3)
        return false;
      hmax = std::max(hmax, comp[c].h);
      vmax = std::max(vmax, comp[c].v);
    }
    mcusx = (W + 8 * hmax - 1) / (8 * hmax);
    mcusy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.bw = mcusx * k.h;
      k.bh = mcusy * k.v;
      k.dw = (W * k.h + hmax - 1) / hmax;
      k.dh = (H * k.v + vmax - 1) / vmax;
      k.cbw = (k.dw + 7) / 8;
      k.cbh = (k.dh + 7) / 8;
      k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
    }
    frame = true;
    return true;
  }

  // ---- entropy decoding of one block ----

  bool block_baseline(Component& k, int16_t* blk) {
    const int s = decode(dc[k.td]);
    if (s < 0 || s > 16) return false;
    const int diff = s ? extend(bits(s), s) : 0;
    k.pred += diff;
    blk[0] = static_cast<int16_t>(k.pred);
    for (int i = 1; i < 64; ++i) {
      const int rs = decode(ac[k.ta]);
      if (rs < 0) return false;
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        i += r;
        blk[kZigzag[i]] = static_cast<int16_t>(extend(bits(sz), sz));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
    return true;
  }

  bool dc_first(Component& k, int16_t* blk, int al) {
    const int s = decode(dc[k.td]);
    if (s < 0 || s > 16) return false;
    k.pred += s ? extend(bits(s), s) : 0;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(k.pred) << al);
    return true;
  }

  void dc_refine(int16_t* blk, int al) {
    if (bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  bool ac_first(Component& k, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return true;
    }
    for (int i = ss; i <= se; ++i) {
      const int rs = decode(ac[k.ta]);
      if (rs < 0) return false;
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        blk[kZigzag[i]] = static_cast<int16_t>(static_cast<unsigned>(extend(bits(s), s)) << al);
      } else {
        if (r == 15) {
          i += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          --eobrun;
          break;
        }
      }
    }
    return true;
  }

  bool ac_refine(Component& k, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    auto refine = [&](int16_t* c) {
      if (bit() && (*c & p1) == 0) *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
    };
    if (eobrun == 0) {
      for (; i <= se; ++i) {
        const int rs = decode(ac[k.ta]);
        if (rs < 0) return false;
        int r = rs >> 4, s = rs & 15, val = 0;
        if (s) {
          val = bit() ? p1 : m1;  // s is 1 in a valid stream
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          break;
        }
        do {
          int16_t* c = blk + kZigzag[i];
          if (*c != 0) {
            refine(c);
          } else {
            if (--r < 0) break;
          }
          ++i;
        } while (i <= se);
        if (val && i <= 63) blk[kZigzag[i]] = static_cast<int16_t>(val);
      }
    }
    if (eobrun > 0) {
      for (; i <= se; ++i) {
        int16_t* c = blk + kZigzag[i];
        if (*c != 0) refine(c);
      }
      --eobrun;
    }
    return true;
  }

  // ---- a scan ----

  bool read_restart_marker() {
    // the bits of the interval are dropped; the marker is looked for at
    // the next byte boundary, and a missing one is passed over
    reset_bits();
    while (pos + 1 < len) {
      if (data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) {
        pos += 2;
        break;
      }
      if (data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF) break;
      ++pos;
    }
    insufficient = false;
    return true;
  }

  bool read_sos(int n) {
    if (!frame) return false;
    const size_t end = pos + n;
    const int ns = byte();
    if (ns < 1 || ns > 4 || n != 4 + 2 * ns) return false;
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int id = byte(), t = byte();
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) sc[i] = &comp[c];
      if (!sc[i]) return false;
      sc[i]->td = t >> 4;
      sc[i]->ta = t & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3) return false;
    }
    const int ss = byte(), se = byte(), a = byte();
    const int ah = a >> 4, al = a & 15;
    if (pos != end) return false;
    if (progressive) {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) return false;
    } else if (ss != 0 || se != 63 || a != 0) {
      return false;
    }
    for (int i = 0; i < ns; ++i) {
      sc[i]->pred = 0;
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive || ss > 0;
      if (need_dc && !dc[sc[i]->td].defined) return false;
      if (need_ac && !ac[sc[i]->ta].defined) return false;
    }
    eobrun = 0;
    reset_bits();
    insufficient = false;

    auto one_block = [&](Component& k, int bx, int by) -> bool {
      int16_t* blk = k.coef.data() + (static_cast<size_t>(by) * k.bw + bx) * 64;
      if (!progressive) return block_baseline(k, blk);
      if (ss == 0) {
        if (ah == 0) return dc_first(k, blk, al);
        dc_refine(blk, al);
        return true;
      }
      return ah == 0 ? ac_first(k, blk, ss, se, al) : ac_refine(k, blk, ss, se, al);
    };

    int nmcu, mx;
    if (ns == 1) {  // non-interleaved: the component's own blocks, one an MCU
      nmcu = sc[0]->cbw * sc[0]->cbh;
      mx = sc[0]->cbw;
    } else {
      nmcu = mcusx * mcusy;
      mx = mcusx;
    }
    int todo = restart;
    for (int m = 0; m < nmcu; ++m) {
      if (restart && todo == 0) {
        read_restart_marker();
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        eobrun = 0;
        todo = restart;
      }
      if (!insufficient) {  // past the end of the data the blocks stay zero
        if (ns == 1) {
          if (!one_block(*sc[0], m % mx, m / mx)) return false;
        } else {
          const int bx = m % mx, by = m / mx;
          for (int i = 0; i < ns; ++i) {
            Component& k = *sc[i];
            for (int yy = 0; yy < k.v; ++yy)
              for (int xx = 0; xx < k.h; ++xx)
                if (!one_block(k, bx * k.h + xx, by * k.v + yy)) return false;
          }
        }
      }
      if (restart) --todo;
    }
    // on to the next marker: the rest of the segment's bytes are passed over
    while (pos + 1 < len) {
      if (data[pos] == 0xFF && data[pos + 1] != 0x00 &&
          !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) && data[pos + 1] != 0xFF)
        break;
      ++pos;
    }
    return true;
  }

  // 0 decoded (to EOI or the end of the data); 1 corrupt or not read here
  int run(bool header_only) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return 1;
    pos = 2;
    bool scans = false;
    while (true) {
      int m = byte();
      if (m < 0) return scans ? 0 : 1;
      if (m != 0xFF) continue;  // stray bytes between segments are skipped
      do m = byte(); while (m == 0xFF);
      if (m < 0) return scans ? 0 : 1;
      if (m == 0xD9) return scans || header_only ? 0 : 1;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      const int n = u16();
      if (n < 2 || pos + n - 2 > len) return scans ? 0 : 1;
      const size_t next = pos + n - 2;
      bool ok = true;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        ok = read_sof(n - 2, m);
        if (ok && header_only) return 0;
      } else if (m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        return 1;  // lossless, hierarchical or arithmetic coding
      } else if (m == 0xC4) {
        ok = read_dht(n - 2);
      } else if (m == 0xDB) {
        ok = read_dqt(n - 2);
      } else if (m == 0xDD) {
        restart = n == 4 ? u16() : -1;
        ok = restart >= 0;
      } else if (m == 0xE0) {
        jfif = jfif || (n >= 7 && std::memcmp(data + pos, "JFIF\0", 5) == 0);
      } else if (m == 0xEE) {
        if (n >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[pos + 11];
        }
      } else if (m == 0xDA) {
        if (header_only) return 1;
        if (!read_sos(n - 2)) return scans ? 0 : 1;
        scans = true;
        continue;  // pos is at the next marker
      }
      if (!ok) return 1;
      pos = next;
    }
  }

  // 2 for CMYK / YCCK, 1 for a layout not read here, 0 RGB out of YCbCr
  // (ycc = 1), RGB (0) or grayscale (-1)
  int color(int* ycc) const {
    if (ncomp == 1) {
      *ycc = -1;
      return 0;
    }
    if (ncomp == 4) return 2;
    if (ncomp != 3) return 1;
    if (jfif) {
      *ycc = 1;
    } else if (adobe) {
      *ycc = adobe_transform == 0 ? 0 : 1;
    } else {
      *ycc = (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B') ? 0 : 1;
    }
    return 0;
  }
};

// ---- the IDCT --------------------------------------------------------------

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) {
  return static_cast<int32_t>((x + (1LL << (n - 1))) >> n);
}

// libjpeg's post-IDCT range limit: x + 128 clamped to [0, 255], x taken
// modulo 1024 into [-512, 511] first (the table's wrap-around)
inline uint8_t range_limit(int32_t x) {
  const int32_t v = ((x + 512) & 1023) - 512 + 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jidctint.c's jpeg_idct_islow: coefficients in natural order, the
// quantization table in natural order, 8 x 8 samples out
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* w = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      const int32_t dc = static_cast<int32_t>(ip[0]) * qp[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16], z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                  tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int n = CONST_BITS - PASS1_BITS;
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
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    const int n = CONST_BITS + PASS1_BITS + 3;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                  tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    op[0] = range_limit(descale(tmp10 + tmp3, n));
    op[7] = range_limit(descale(tmp10 - tmp3, n));
    op[1] = range_limit(descale(tmp11 + tmp2, n));
    op[6] = range_limit(descale(tmp11 - tmp2, n));
    op[2] = range_limit(descale(tmp12 + tmp1, n));
    op[5] = range_limit(descale(tmp12 - tmp1, n));
    op[3] = range_limit(descale(tmp13 + tmp0, n));
    op[4] = range_limit(descale(tmp13 - tmp0, n));
  }
}

// The M-point inverse DCT of the M x M lowest coefficients (M = 1, 2, 4),
// M x M samples out, rounded once
void idct_reduced(const int16_t* in, const uint16_t* q, uint8_t* out, int stride, int M) {
  double basis[4][4];  // basis[x][u] = C(u) cos((2x + 1) u pi / 2M)
  for (int x = 0; x < M; ++x)
    for (int u = 0; u < M; ++u)
      basis[x][u] = (u == 0 ? std::sqrt(0.5) : 1.0) *
                    std::cos((2 * x + 1) * u * M_PI / (2.0 * M));
  double f[4][4];
  for (int v = 0; v < M; ++v)
    for (int u = 0; u < M; ++u) f[v][u] = static_cast<double>(in[8 * v + u]) * q[8 * v + u];
  for (int y = 0; y < M; ++y)
    for (int x = 0; x < M; ++x) {
      double s = 0.0;
      for (int v = 0; v < M; ++v)
        for (int u = 0; u < M; ++u) s += basis[y][v] * basis[x][u] * f[v][u];
      const long r = std::lround(s / 4.0 + 128.0);
      out[static_cast<size_t>(y) * stride + x] =
          static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
    }
}

// ---- upsampling and colour ------------------------------------------------

struct Plane {
  int w = 0, h = 0;  // the buffer's size (whole blocks)
  int dw = 0, dh = 0;  // the real samples
  std::vector<uint8_t> px;
  uint8_t at(int x, int y) const { return px[static_cast<size_t>(y) * w + x]; }
};

// component c at full output resolution (ow x oh) into out; the fancy
// filters as jdsample.c applies them (h2v1, h1v2, h2v2 when the component
// is more than 2 samples wide and fancy is on), else box replication
void upsample(const Plane& p, int fx, int fy, bool fancy, int ow, int oh, uint8_t* out) {
  const int lastrow = p.dh - 1;
  if (fx == 1 && fy == 1) {
    for (int y = 0; y < oh; ++y) std::memcpy(out + static_cast<size_t>(y) * ow,
                                             p.px.data() + static_cast<size_t>(y) * p.w, ow);
    return;
  }
  const bool h2v1 = fx == 2 && fy == 1 && fancy && p.dw > 2;
  const bool h1v2 = fx == 1 && fy == 2 && fancy;
  const bool h2v2 = fx == 2 && fy == 2 && fancy && p.dw > 2;
  std::vector<int> row(2 * static_cast<size_t>(p.w) + 2);
  for (int y = 0; y < oh; ++y) {
    uint8_t* o = out + static_cast<size_t>(y) * ow;
    const int iy = y / fy;
    if (h2v1) {
      // jdsample.c h2v1_fancy_upsample over the row's dw samples
      const int n = p.dw;
      const uint8_t* in = p.px.data() + static_cast<size_t>(iy) * p.w;
      row[0] = in[0];
      row[1] = (in[0] * 3 + in[1] + 2) >> 2;
      for (int i = 1; i < n - 1; ++i) {
        const int v = in[i] * 3;
        row[2 * i] = (v + in[i - 1] + 1) >> 2;
        row[2 * i + 1] = (v + in[i + 1] + 2) >> 2;
      }
      row[2 * n - 2] = (in[n - 1] * 3 + in[n - 2] + 1) >> 2;
      row[2 * n - 1] = in[n - 1];
      for (int x = 0; x < ow; ++x) o[x] = static_cast<uint8_t>(row[x]);
    } else if (h1v2 || h2v2) {
      // the nearer input row and the next nearer: above for the upper output
      // row of a pair, below for the lower; the first and last real rows
      // stand in past the image's edges
      const int other = std::min(std::max((y % 2 == 0) ? iy - 1 : iy + 1, 0), lastrow);
      const uint8_t* in0 = p.px.data() + static_cast<size_t>(std::min(iy, lastrow)) * p.w;
      const uint8_t* in1 = p.px.data() + static_cast<size_t>(other) * p.w;
      if (h1v2) {
        const int bias = (y % 2 == 0) ? 1 : 2;
        for (int x = 0; x < ow; ++x) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      } else {
        const int n = p.dw;
        int thiss = in0[0] * 3 + in1[0], next = in0[1] * 3 + in1[1], last;
        row[0] = (thiss * 4 + 8) >> 4;
        row[1] = (thiss * 3 + next + 7) >> 4;
        last = thiss;
        thiss = next;
        for (int i = 1; i < n - 1; ++i) {
          next = in0[i + 1] * 3 + in1[i + 1];
          row[2 * i] = (thiss * 3 + last + 8) >> 4;
          row[2 * i + 1] = (thiss * 3 + next + 7) >> 4;
          last = thiss;
          thiss = next;
        }
        row[2 * n - 2] = (thiss * 3 + last + 8) >> 4;
        row[2 * n - 1] = (thiss * 4 + 7) >> 4;
        for (int x = 0; x < ow; ++x) o[x] = static_cast<uint8_t>(row[x]);
      }
    } else {
      const uint8_t* in = p.px.data() + static_cast<size_t>(iy) * p.w;
      for (int x = 0; x < ow; ++x) o[x] = in[x / fx];
    }
  }
}

// jdcolor.c's tables
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int SCALEBITS = 16;
    constexpr int32_t ONE_HALF = 1 << (SCALEBITS - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1L << SCALEBITS) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};

inline uint8_t clamp8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// The decoded image as interleaved RGB at scale M / 8: rc 0 (out, ow, oh set)
int decode_image(const uint8_t* data, size_t len, int M, std::vector<uint8_t>& rgb, int* ow,
                 int* oh) {
  Decoder d(data, len);
  if (d.run(false) != 0) return 1;
  int ycc = 0;
  const int cs = d.color(&ycc);
  if (cs) return cs;
  for (int c = 0; c < d.ncomp; ++c)
    if (!d.qt_defined[d.comp[c].tq]) return 1;
  for (int c = 0; c < d.ncomp; ++c)
    if (d.hmax % d.comp[c].h || d.vmax % d.comp[c].v) return 1;
  const int W = (d.W * M + 7) / 8, H = (d.H * M + 7) / 8;
  std::vector<Plane> planes(d.ncomp);
  for (int c = 0; c < d.ncomp; ++c) {
    const Component& k = d.comp[c];
    Plane& p = planes[c];
    p.w = k.bw * M;
    p.h = k.bh * M;
    p.dw = (d.W * k.h * M + d.hmax * 8 - 1) / (d.hmax * 8);
    p.dh = (d.H * k.v * M + d.vmax * 8 - 1) / (d.vmax * 8);
    p.px.assign(static_cast<size_t>(p.w) * p.h, 0);
    const uint16_t* q = d.qt[k.tq];
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx) {
        const int16_t* blk = k.coef.data() + (static_cast<size_t>(by) * k.bw + bx) * 64;
        uint8_t* o = p.px.data() + static_cast<size_t>(by) * M * p.w + bx * M;
        if (M == 8)
          idct_islow(blk, q, o, p.w);
        else
          idct_reduced(blk, q, o, p.w, M);
      }
  }
  rgb.assign(static_cast<size_t>(W) * H * 3, 0);
  *ow = W;
  *oh = H;
  std::vector<std::vector<uint8_t>> full(d.ncomp);
  for (int c = 0; c < d.ncomp; ++c) {
    full[c].assign(static_cast<size_t>(W) * H, 0);
    upsample(planes[c], d.hmax / d.comp[c].h, d.vmax / d.comp[c].v, M > 1, W, H,
             full[c].data());
  }
  static const YccTables t;
  for (size_t i = 0, n = static_cast<size_t>(W) * H; i < n; ++i) {
    uint8_t* o = rgb.data() + 3 * i;
    if (ycc < 0) {
      o[0] = o[1] = o[2] = full[0][i];
    } else if (ycc == 0) {
      o[0] = full[0][i];
      o[1] = full[1][i];
      o[2] = full[2][i];
    } else {
      const int y = full[0][i], cb = full[1][i], cr = full[2][i];
      o[0] = clamp8(y + t.cr_r[cr]);
      o[1] = clamp8(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[2] = clamp8(y + t.cb_b[cb]);
    }
  }
  return 0;
}

// ---- Pillow-compatible convolution resampling (fixed point) ----

constexpr int PRECISION_BITS = 32 - 8 - 2;  // Pillow's 8-bit precision

inline double bicubic_filter(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// int32 accumulation is safe: weights sum to 1 << 22, so the sum stays
// below 255 * 2^22 + 2^21 < 2^31 whatever the taps
inline uint8_t clip8(int32_t v) {
  v >>= PRECISION_BITS;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Each output's taps: bounds[2 i] the first input, bounds[2 i + 1] their
// count; kk[i ksize ...] the fixed-point weights
int precompute_coeffs(int in_size, double in0, double in1, int out_size,
                      std::vector<int>& bounds, std::vector<int>& kk) {
  const double scale = (in1 - in0) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 2.0 * filterscale;  // bicubic support = 2
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.assign(2 * out_size, 0);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> w(ksize);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; xx++) {
    const double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double wsum = 0.0;
    for (int x = 0; x < xmax; x++) {
      w[x] = bicubic_filter((x + xmin - center + 0.5) * ss);
      wsum += w[x];
    }
    for (int x = 0; x < xmax; x++) {
      const double c = wsum == 0.0 ? 0.0 : w[x] / wsum;
      kk[static_cast<size_t>(xx) * ksize + x] = static_cast<int>(
          c < 0 ? (c * (1 << PRECISION_BITS) - 0.5) : (c * (1 << PRECISION_BITS) + 0.5));
    }
    bounds[2 * xx] = xmin;
    bounds[2 * xx + 1] = xmax;
  }
  return ksize;
}

// Horizontal then vertical, each channel planar; out_u8 interleaved HWC, or
// out_f32 normalized CHW (the clipped uint8 normalized, so that it equals
// "PIL resize, then (x / 255 - mean) / std")
void resample_rgb(const uint8_t* in, int in_w, int in_h, int in_stride, double bx0, double by0,
                  double bx1, double by1, int out_w, int out_h, uint8_t* out_u8, float* out_f32,
                  const float* mean, const float* stdv) {
  std::vector<int> hb, hk, vb, vk;
  const int hks = precompute_coeffs(in_w, bx0, bx1, out_w, hb, hk);
  const int vks = precompute_coeffs(in_h, by0, by1, out_h, vb, vk);
  std::vector<uint8_t> plane(static_cast<size_t>(in_h) * in_w);
  std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w);
  std::vector<int32_t> acc(static_cast<size_t>(out_w));
  for (int c = 0; c < 3; c++) {
    for (int y = 0; y < in_h; y++) {
      const uint8_t* row = in + static_cast<size_t>(y) * in_stride + c;
      uint8_t* prow = plane.data() + static_cast<size_t>(y) * in_w;
      for (int x = 0; x < in_w; x++) prow[x] = row[3 * x];
    }
    for (int y = 0; y < in_h; y++) {
      const uint8_t* prow = plane.data() + static_cast<size_t>(y) * in_w;
      uint8_t* trow = tmp.data() + static_cast<size_t>(y) * out_w;
      for (int xx = 0; xx < out_w; xx++) {
        const int xmin = hb[2 * xx], n = hb[2 * xx + 1];
        const int* k = hk.data() + static_cast<size_t>(xx) * hks;
        int32_t s = 1 << (PRECISION_BITS - 1);
        const uint8_t* p = prow + xmin;
        for (int x = 0; x < n; x++) s += static_cast<int32_t>(p[x]) * k[x];
        trow[xx] = clip8(s);
      }
    }
    const float sc = out_f32 ? 1.0f / (255.0f * stdv[c]) : 0.0f;
    const float bi = out_f32 ? -mean[c] / stdv[c] : 0.0f;
    float* oplane = out_f32 ? out_f32 + static_cast<size_t>(c) * out_w * out_h : nullptr;
    for (int yy = 0; yy < out_h; yy++) {
      const int ymin = vb[2 * yy], n = vb[2 * yy + 1];
      const int* k = vk.data() + static_cast<size_t>(yy) * vks;
      std::fill(acc.begin(), acc.end(), 1 << (PRECISION_BITS - 1));
      for (int y = 0; y < n; y++) {
        const int32_t kk = k[y];
        const uint8_t* trow = tmp.data() + static_cast<size_t>(ymin + y) * out_w;
        int32_t* a = acc.data();
        for (int x = 0; x < out_w; x++) a[x] += static_cast<int32_t>(trow[x]) * kk;
      }
      if (oplane) {
        float* orow = oplane + static_cast<size_t>(yy) * out_w;
        for (int x = 0; x < out_w; x++) orow[x] = static_cast<float>(clip8(acc[x])) * sc + bi;
      } else {
        uint8_t* orow = out_u8 + (static_cast<size_t>(yy) * out_w) * 3 + c;
        for (int x = 0; x < out_w; x++) orow[3 * x] = clip8(acc[x]);
      }
    }
  }
}

void clamp_crop(int W, int H, int* x, int* y, int* w, int* h) {
  if (*w <= 0 || *h <= 0) {
    *x = *y = 0;
    *w = W;
    *h = H;
  }
  *x = std::max(0, std::min(*x, W - 1));
  *y = std::max(0, std::min(*y, H - 1));
  *w = std::min(*w, W - *x);
  *h = std::min(*h, H - *y);
}

}  // namespace

extern "C" {

// Resize (+ optional fused normalize) an already-decoded uint8 HWC RGB image
// (the other formats' share of the pipeline), with the same semantics.
int madtp_resize_norm(const uint8_t* in, int in_w, int in_h, int crop_x, int crop_y, int crop_w,
                      int crop_h, int out_w, int out_h, int fuse_norm, const float* mean,
                      const float* stdv, uint8_t* out_u8, float* out_f32) {
  clamp_crop(in_w, in_h, &crop_x, &crop_y, &crop_w, &crop_h);
  resample_rgb(in + (static_cast<size_t>(crop_y) * in_w + crop_x) * 3, crop_w, crop_h, in_w * 3,
               0.0, 0.0, crop_w, crop_h, out_w, out_h, fuse_norm ? nullptr : out_u8,
               fuse_norm ? out_f32 : nullptr, mean, stdv);
  return 0;
}

// The image's width and height from its frame header.  Returns 0 on success.
int madtp_jpeg_dims(const uint8_t* data, size_t len, int* w, int* h) {
  Decoder d(data, len);
  if (d.run(true) != 0 || !d.frame) return 1;
  *w = d.W;
  *h = d.H;
  return 0;
}

// Decode `data`, crop (full-resolution pixel coordinates; crop_w <= 0: the
// whole image), resize to (out_w, out_h) as PIL's bicubic resize does.
// allow_dct_scale: decode at M / 8 (never below the target).  fuse_norm: 0
// -> out_u8 gets HWC RGB; 1 -> out_f32 gets normalized float32 CHW.
int madtp_decode_resize(const uint8_t* data, size_t len, int crop_x, int crop_y, int crop_w,
                        int crop_h, int out_w, int out_h, int allow_dct_scale, int fuse_norm,
                        const float* mean, const float* stdv, uint8_t* out_u8, float* out_f32) {
  int W = 0, H = 0;
  if (madtp_jpeg_dims(data, len, &W, &H)) return 1;
  clamp_crop(W, H, &crop_x, &crop_y, &crop_w, &crop_h);
  int M = 8;
  if (allow_dct_scale) {
    for (int m : {1, 2, 4}) {
      if (static_cast<int64_t>(crop_w) * m >= static_cast<int64_t>(out_w) * 8 &&
          static_cast<int64_t>(crop_h) * m >= static_cast<int64_t>(out_h) * 8) {
        M = m;
        break;
      }
    }
  }
  std::vector<uint8_t> rgb;
  int SW = 0, SH = 0;
  const int rc = decode_image(data, len, M, rgb, &SW, &SH);
  if (rc) return rc;
  // the crop box at the decoded scale (float: the resampler keeps its
  // sub-pixel position), presented to the resampler as exactly the crop
  // region, so that its taps clamp at the crop's edges as PIL's crop().resize()
  const double s = static_cast<double>(M) / 8.0;
  const double fx0 = crop_x * s, fy0 = crop_y * s;
  const double fx1 = std::min<double>((crop_x + crop_w) * s, SW);
  const double fy1 = std::min<double>((crop_y + crop_h) * s, SH);
  const int ix0 = std::max(0, static_cast<int>(std::floor(fx0)));
  const int iy0 = std::max(0, static_cast<int>(std::floor(fy0)));
  const int ix1 = std::min(SW, std::max(ix0 + 1, static_cast<int>(std::ceil(fx1))));
  const int iy1 = std::min(SH, std::max(iy0 + 1, static_cast<int>(std::ceil(fy1))));
  resample_rgb(rgb.data() + (static_cast<size_t>(iy0) * SW + ix0) * 3, ix1 - ix0, iy1 - iy0,
               SW * 3, fx0 - ix0, fy0 - iy0, fx1 - ix0, fy1 - iy0, out_w, out_h,
               fuse_norm ? nullptr : out_u8, fuse_norm ? out_f32 : nullptr, mean, stdv);
  return 0;
}

}  // extern "C"
