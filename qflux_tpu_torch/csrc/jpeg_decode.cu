// JPEG decoding on the host: the per-symbol and per-pixel work of
// qflux_tpu_torch/utils/jpeg.py (`_decode_plain`), the same steps in the
// same order, equal to it (and to libjpeg-turbo 3.1 as cv2.imread calls it)
// to the bit.  Host code only: nvcc hands it to the host compiler, and it is
// linked into the kernel library with the CUDA sources.
//
// utils/jpeg.py parses the file (markers, tables, scan headers; the
// entropy-coded bytes unstuffed and split at their restart markers) and
// passes flat arrays:
//   data       the scans' unstuffed bytes end to end, 8 zero bytes after;
//   scans      SCAN_FIELDS int32 a scan: number of components, their
//              indices (4), DC and AC table indices (4 + 4, -1 where the
//              scan needs none), Ss, Se, Ah, Al, MCUs across and down,
//              the restart interval, the first of its restart intervals
//              in `intervals` and their number;
//   intervals  [start, end) byte offsets of each restart interval in data;
//   tables     272 bytes a Huffman table: 16 counts, 256 values;
//   comps      COMP_FIELDS int32 a component: h, v, blocks across and down
//              (the padded grid), plane width and height, whether the
//              output needs it;
//   qt         64 int32 quantizers a component, in natural order.
// The output is [height, width, channels] uint8 (1 channel for the gray
// conversions, else 3, RGB).
//
// Steps: Huffman decoding into int16 coefficient arrays (jdhuff.c's
// sequential decode_mcu, jdphuff.c's DC / AC first and refinement scans
// with EOB runs), dequantization and jidctint.c's jpeg_idct_islow with the
// post-IDCT range-limit table, jdsample.c's upsampling (h2v1 / h2v2 fancy
// where a plane is wider than 2 samples, h1v2 fancy, else replication) and
// jdcolor.c's fixed-point colour conversion.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int SCAN_FIELDS = 24;
constexpr int COMP_FIELDS = 8;
enum { S_NCOMP = 0, S_COMP = 1, S_DC = 5, S_AC = 9, S_SS = 13, S_SE = 14, S_AH = 15,
       S_AL = 16, S_MCUX = 17, S_MCUY = 18, S_RESTART = 19, S_IFIRST = 20, S_NINT = 21 };
enum { GRAY_OF_Y = 0, YCC_TO_RGB = 1, RGB_TO_RGB = 2, RGB_TO_GRAY = 3 };
enum { ERR_CODE = 1, ERR_INDEX = 2, ERR_SHORT = 3, ERR_ARG = 4 };

constexpr int kNatural[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// The next 16 bits -> length << 8 | symbol, 0 where no code matches.
std::vector<uint32_t> make_lut(const uint8_t* table) {
  std::vector<uint32_t> lut(1 << 16, 0);
  const uint8_t* counts = table;
  const uint8_t* values = table + 16;
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      uint32_t lo = code << (16 - len), hi = (code + 1) << (16 - len);
      if (hi > (1u << 16)) return lut;  // the parser refuses such a table first
      for (uint32_t e = lo; e < hi; ++e) lut[e] = (uint32_t(len) << 8) | values[k];
    }
    code <<= 1;
  }
  return lut;
}

struct Bits {
  const uint8_t* d;
  int64_t size;  // bytes readable from d (the zero padding included)
  int64_t p;     // bit position

  // the 32 bits from the byte that holds bit p on
  inline uint32_t window() const {
    int64_t b = p >> 3;
    if (b + 4 <= size)
      return (uint32_t(d[b]) << 24) | (uint32_t(d[b + 1]) << 16) | (uint32_t(d[b + 2]) << 8) |
             uint32_t(d[b + 3]);
    uint32_t w = 0;
    for (int i = 0; i < 4; ++i) w = (w << 8) | (b + i < size && b + i >= 0 ? d[b + i] : 0);
    return w;
  }
  inline uint32_t peek16() const { return (window() >> (16 - (p & 7))) & 0xFFFF; }
  inline int get(int n) {  // n in 1..16
    int v = int((window() >> (32 - (p & 7) - n)) & ((1u << n) - 1));
    p += n;
    return v;
  }
  inline int bit() {
    int v = int((window() >> (31 - (p & 7))) & 1);
    p += 1;
    return v;
  }
  // a Huffman symbol, or -1 where no code matches
  inline int decode(const std::vector<uint32_t>& lut) {
    uint32_t e = lut[peek16()];
    if (!e) return -1;
    p += e >> 8;
    return int(e & 255);
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - ((1 << s) - 1) : r; }

struct Comp {
  int h, v, pbw, pbh, width, height, needed;
};

// One scan's MCUs into the coefficient arrays; 0 or an error code.
int decode_scan(const int32_t* s, const uint8_t* data, int64_t data_size,
                const int32_t* intervals, const std::vector<std::vector<uint32_t>>& luts,
                const std::vector<Comp>& comps, std::vector<std::vector<int16_t>>& coefs,
                bool progressive) {
  const int n = s[S_NCOMP];
  const int ss = s[S_SS], se = s[S_SE], ah = s[S_AH], al = s[S_AL];
  const int mcux = s[S_MCUX], mcuy = s[S_MCUY];
  const int64_t total = int64_t(mcux) * mcuy;
  const int64_t per = s[S_RESTART] ? s[S_RESTART] : total;
  enum { SEQ, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } kind =
      !progressive ? SEQ
      : ss == 0    ? (ah == 0 ? DC_FIRST : DC_REFINE)
                   : (ah == 0 ? AC_FIRST : AC_REFINE);
  const std::vector<uint32_t>* dcl[4] = {nullptr, nullptr, nullptr, nullptr};
  const std::vector<uint32_t>* acl[4] = {nullptr, nullptr, nullptr, nullptr};
  for (int j = 0; j < n; ++j) {
    int dc = s[S_DC + j], ac = s[S_AC + j];
    bool need_dc = kind == SEQ || kind == DC_FIRST, need_ac = kind == SEQ || kind >= AC_FIRST;
    if ((need_dc && (dc < 0 || dc >= int(luts.size()))) ||
        (need_ac && (ac < 0 || ac >= int(luts.size()))))
      return ERR_ARG;
    if (need_dc) dcl[j] = &luts[dc];
    if (need_ac) acl[j] = &luts[ac];
  }
  // per block of an MCU: (component slot, block row offset, block column offset)
  int layout[10][3];
  int nblocks = 0;
  if (n == 1) {
    layout[0][0] = layout[0][1] = layout[0][2] = 0;
    nblocks = 1;
  } else {
    for (int j = 0; j < n; ++j) {
      const Comp& c = comps[s[S_COMP + j]];
      for (int y = 0; y < c.v; ++y)
        for (int x = 0; x < c.h; ++x) {
          if (nblocks == 10) return ERR_ARG;
          layout[nblocks][0] = j;
          layout[nblocks][1] = y;
          layout[nblocks][2] = x;
          ++nblocks;
        }
    }
  }
  const int p1 = 1 << al, m1 = -1 * (1 << al);
  int64_t mcu = 0;
  for (int iv = 0; iv < s[S_NINT]; ++iv) {
    const int32_t* range = intervals + 2 * int64_t(s[S_IFIRST] + iv);
    Bits br{data, data_size, int64_t(range[0]) * 8};
    const int64_t pend = int64_t(range[1]) * 8;
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    const int64_t stop = mcu + per < total ? mcu + per : total;
    for (int64_t m = mcu; m < stop; ++m) {
      const int64_t my = m / mcux, mx = m % mcux;
      for (int b = 0; b < nblocks; ++b) {
        const int j = layout[b][0];
        const Comp& c = comps[s[S_COMP + j]];
        const int64_t base =
            n == 1 ? (my * c.pbw + mx) * 64
                   : ((my * c.v + layout[b][1]) * c.pbw + mx * c.h + layout[b][2]) * 64;
        int16_t* blk = coefs[s[S_COMP + j]].data() + base;
        if (kind == SEQ || kind == DC_FIRST) {
          int t = br.decode(*dcl[j]);
          if (t < 0) return ERR_CODE;
          if (t) pred[j] += extend(br.get(t), t);
          if (kind == DC_FIRST) {
            blk[0] = int16_t(pred[j] * (1 << al));
            continue;
          }
          blk[0] = int16_t(pred[j]);
          const std::vector<uint32_t>& lut = *acl[j];
          for (int k = 1; k < 64; ++k) {
            int rs = br.decode(lut);
            if (rs < 0) return ERR_CODE;
            int r = rs >> 4, t2 = rs & 15;
            if (t2) {
              k += r;
              if (k > 63) return ERR_INDEX;
              blk[kNatural[k]] = int16_t(extend(br.get(t2), t2));
            } else if (r != 15) {
              break;
            } else {
              k += 15;
            }
          }
        } else if (kind == DC_REFINE) {
          if (br.bit()) blk[0] = int16_t(blk[0] | p1);
        } else if (kind == AC_FIRST) {
          if (eobrun) {
            --eobrun;
            continue;
          }
          const std::vector<uint32_t>& lut = *acl[j];
          for (int k = ss; k <= se; ++k) {
            int rs = br.decode(lut);
            if (rs < 0) return ERR_CODE;
            int r = rs >> 4, t = rs & 15;
            if (t) {
              k += r;
              if (k > 63) return ERR_INDEX;
              blk[kNatural[k]] = int16_t(extend(br.get(t), t) * p1);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = 1 << r;
              if (r) eobrun += br.get(r);
              --eobrun;
              break;
            }
          }
        } else {  // AC_REFINE
          const std::vector<uint32_t>& lut = *acl[j];
          int k = ss;
          if (!eobrun) {
            for (; k <= se; ++k) {
              int rs = br.decode(lut);
              if (rs < 0) return ERR_CODE;
              int r = rs >> 4, t = rs & 15;
              if (t) {
                t = br.bit() ? p1 : m1;
              } else if (r != 15) {
                eobrun = 1 << r;
                if (r) eobrun += br.get(r);
                break;
              }
              while (k <= se) {
                int16_t* coef = blk + kNatural[k];
                if (*coef) {
                  if (br.bit() && !(*coef & p1))
                    *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
                } else if (--r < 0) {
                  break;
                }
                ++k;
              }
              if (t) {
                if (k > 63) return ERR_INDEX;
                blk[kNatural[k]] = int16_t(t);
              }
            }
          }
          if (eobrun) {
            for (; k <= se; ++k) {
              int16_t* coef = blk + kNatural[k];
              if (*coef && br.bit() && !(*coef & p1))
                *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
            --eobrun;
          }
        }
      }
      if (br.p > pend) return ERR_SHORT;
    }
    mcu += per;
  }
  return 0;
}

// jdmaster.c's post-IDCT range-limit table, indexed by x & 1023
struct Limit {
  uint8_t t[1024];
  Limit() {
    for (int i = 0; i < 1024; ++i)
      t[i] = uint8_t(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
  }
};

// jpeg_idct_islow's butterfly: 8 inputs (stride apart) -> 8 outputs before descale
inline void butterfly(const int64_t* d, int64_t* o) {
  int64_t z1 = (d[2] + d[6]) * 4433;
  int64_t tmp2 = z1 + d[6] * -15137, tmp3 = z1 + d[2] * 6270;
  int64_t tmp0 = (d[0] + d[4]) * 8192, tmp1 = (d[0] - d[4]) * 8192;
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = d[7], t1 = d[5], t2 = d[3], t3 = d[1];
  int64_t z1o = t0 + t3, z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1o *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1o + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1o + z4;
  o[0] = tmp10 + t3;
  o[7] = tmp10 - t3;
  o[1] = tmp11 + t2;
  o[6] = tmp11 - t2;
  o[2] = tmp12 + t1;
  o[5] = tmp12 - t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
}

void idct_islow(const int16_t* coef, const int32_t* q, const Limit& lim, uint8_t* out,
                int64_t stride) {
  int32_t ws[64];
  int64_t d[8], o[8];
  for (int col = 0; col < 8; ++col) {  // pass 1, down the columns
    bool ac_zero = true;
    for (int r = 1; r < 8; ++r) ac_zero &= coef[8 * r + col] == 0;
    if (ac_zero) {
      int32_t dc = int32_t(int64_t(coef[col]) * q[col] * 4);
      for (int r = 0; r < 8; ++r) ws[8 * r + col] = dc;
      continue;
    }
    for (int r = 0; r < 8; ++r) d[r] = int64_t(coef[8 * r + col]) * q[8 * r + col];
    butterfly(d, o);
    for (int r = 0; r < 8; ++r) ws[8 * r + col] = int32_t((o[r] + 1024) >> 11);
  }
  for (int row = 0; row < 8; ++row) {  // pass 2, along the rows
    const int32_t* w = ws + 8 * row;
    uint8_t* dst = out + row * stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      uint8_t v = lim.t[((int64_t(w[0]) + 16) >> 5) & 1023];
      for (int c = 0; c < 8; ++c) dst[c] = v;
      continue;
    }
    for (int c = 0; c < 8; ++c) d[c] = w[c];
    butterfly(d, o);
    for (int c = 0; c < 8; ++c) dst[c] = lim.t[((o[c] + (int64_t(1) << 17)) >> 18) & 1023];
  }
}

// one component's plane [ch, cw] (row stride `stride`) -> [ch * vx, cw * hx]
void upsample(const uint8_t* in, int64_t stride, int cw, int ch, int hx, int vx,
              std::vector<uint8_t>& out) {
  const int64_t ow = int64_t(cw) * hx, oh = int64_t(ch) * vx;
  out.resize(ow * oh);
  auto row = [&](int64_t y) { return in + (y < 0 ? 0 : y >= ch ? ch - 1 : y) * stride; };
  if (hx == 2 && vx == 1 && cw > 2) {  // h2v1_fancy_upsample
    for (int64_t y = 0; y < ch; ++y) {
      const uint8_t* x = row(y);
      uint8_t* o = out.data() + y * ow;
      o[0] = x[0];
      o[1] = uint8_t((x[0] * 3 + x[1] + 2) >> 2);
      for (int j = 1; j < cw - 1; ++j) {
        int v = x[j] * 3;
        o[2 * j] = uint8_t((v + x[j - 1] + 1) >> 2);
        o[2 * j + 1] = uint8_t((v + x[j + 1] + 2) >> 2);
      }
      o[2 * cw - 2] = uint8_t((x[cw - 1] * 3 + x[cw - 2] + 1) >> 2);
      o[2 * cw - 1] = x[cw - 1];
    }
  } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    for (int64_t y = 0; y < ch; ++y) {
      const uint8_t* x = row(y);
      for (int v = 0; v < 2; ++v) {
        const uint8_t* far = row(v == 0 ? y - 1 : y + 1);
        const int bias = v == 0 ? 1 : 2;
        uint8_t* o = out.data() + (2 * y + v) * ow;
        for (int j = 0; j < cw; ++j) o[j] = uint8_t((x[j] * 3 + far[j] + bias) >> 2);
      }
    }
  } else if (hx == 2 && vx == 2 && cw > 2) {  // h2v2_fancy_upsample
    for (int64_t y = 0; y < ch; ++y) {
      const uint8_t* x = row(y);
      for (int v = 0; v < 2; ++v) {
        const uint8_t* far = row(v == 0 ? y - 1 : y + 1);
        uint8_t* o = out.data() + (2 * y + v) * ow;
        int this_sum = x[0] * 3 + far[0], next_sum = x[1] * 3 + far[1], last_sum;
        o[0] = uint8_t((this_sum * 4 + 8) >> 4);
        o[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
        for (int j = 2; j < cw; ++j) {
          next_sum = x[j] * 3 + far[j];
          o[2 * j - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
          o[2 * j - 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        o[2 * cw - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * cw - 1] = uint8_t((this_sum * 4 + 7) >> 4);
      }
    }
  } else {  // fullsize, h2v1 / h2v2 replication, int_upsample
    for (int64_t y = 0; y < oh; ++y) {
      const uint8_t* x = in + (y / vx) * stride;
      uint8_t* o = out.data() + y * ow;
      for (int64_t j = 0; j < ow; ++j) o[j] = x[j / hx];
    }
  }
}

inline int64_t fix(double x) { return int64_t(x * 65536 + 0.5); }
inline uint8_t clamp255(int64_t v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

}  // namespace

extern "C" int qflux_jpeg_decode(const uint8_t* data, const int32_t* scans, int n_scans,
                                 const int32_t* intervals, const uint8_t* tables,
                                 const int32_t* comps_in, const int32_t* qt, int n_comps,
                                 int width, int height, int max_h, int max_v, int progressive,
                                 int color, uint8_t* out) {
  if (n_comps < 1 || n_comps > 4 || width < 1 || height < 1 || max_h < 1 || max_v < 1)
    return ERR_ARG;
  std::vector<Comp> comps(n_comps);
  std::vector<std::vector<int16_t>> coefs(n_comps);
  for (int k = 0; k < n_comps; ++k) {
    const int32_t* c = comps_in + COMP_FIELDS * k;
    comps[k] = {c[0], c[1], c[2], c[3], c[4], c[5], c[6]};
    if (c[0] < 1 || c[1] < 1 || max_h % c[0] || max_v % c[1]) return ERR_ARG;
    coefs[k].assign(size_t(c[2]) * c[3] * 64, 0);
  }
  // the tables the scans use, and the bytes the intervals cover
  int n_tables = 0;
  int64_t data_size = 0;
  for (int i = 0; i < n_scans; ++i) {
    const int32_t* s = scans + SCAN_FIELDS * i;
    for (int j = 0; j < 8; ++j)
      if (s[S_DC + j] + 1 > n_tables) n_tables = s[S_DC + j] + 1;
    for (int v = 0; v < s[S_NINT]; ++v) {
      int64_t e = intervals[2 * int64_t(s[S_IFIRST] + v) + 1];
      if (e > data_size) data_size = e;
    }
  }
  std::vector<std::vector<uint32_t>> luts;
  for (int t = 0; t < n_tables; ++t) luts.push_back(make_lut(tables + 272 * int64_t(t)));
  for (int i = 0; i < n_scans; ++i) {
    int err = decode_scan(scans + SCAN_FIELDS * i, data, data_size + 8, intervals, luts, comps,
                          coefs, progressive != 0);
    if (err) return err;
  }
  static const Limit lim;
  std::vector<std::vector<uint8_t>> planes(n_comps);
  std::vector<int64_t> plane_w(n_comps);
  std::vector<uint8_t> samples;
  for (int k = 0; k < n_comps; ++k) {
    const Comp& c = comps[k];
    if (!c.needed) continue;
    const int bw = (c.width + 7) / 8, bh = (c.height + 7) / 8;
    const int64_t stride = int64_t(bw) * 8;
    samples.assign(stride * bh * 8, 0);
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx)
        idct_islow(coefs[k].data() + (int64_t(by) * c.pbw + bx) * 64, qt + 64 * k, lim,
                   samples.data() + int64_t(by) * 8 * stride + bx * 8, stride);
    upsample(samples.data(), stride, c.width, c.height, max_h / c.h, max_v / c.v, planes[k]);
    plane_w[k] = int64_t(c.width) * (max_h / c.h);
  }
  if (color == GRAY_OF_Y) {
    for (int64_t y = 0; y < height; ++y)
      std::memcpy(out + y * width, planes[0].data() + y * plane_w[0], size_t(width));
    return 0;
  }
  if (n_comps != 3) return ERR_ARG;
  const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data();
  if (color == RGB_TO_GRAY) {
    const int64_t yr = fix(0.299), yg = fix(0.587), yb = fix(0.114);
    for (int64_t y = 0; y < height; ++y)
      for (int64_t x = 0; x < width; ++x)
        out[y * width + x] = uint8_t((p0[y * plane_w[0] + x] * yr + p1[y * plane_w[1] + x] * yg +
                                      p2[y * plane_w[2] + x] * yb + 32768) >> 16);
    return 0;
  }
  if (color == RGB_TO_RGB) {
    for (int64_t y = 0; y < height; ++y)
      for (int64_t x = 0; x < width; ++x) {
        uint8_t* o = out + 3 * (y * width + x);
        o[0] = p0[y * plane_w[0] + x];
        o[1] = p1[y * plane_w[1] + x];
        o[2] = p2[y * plane_w[2] + x];
      }
    return 0;
  }
  if (color != YCC_TO_RGB) return ERR_ARG;
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int64_t x = i - 128;
    cr_r[i] = int((fix(1.40200) * x + 32768) >> 16);
    cb_b[i] = int((fix(1.77200) * x + 32768) >> 16);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + 32768;
  }
  for (int64_t y = 0; y < height; ++y)
    for (int64_t x = 0; x < width; ++x) {
      int yy = p0[y * plane_w[0] + x], cb = p1[y * plane_w[1] + x], cr = p2[y * plane_w[2] + x];
      uint8_t* o = out + 3 * (y * width + x);
      o[0] = clamp255(yy + cr_r[cr]);
      o[1] = clamp255(yy + ((cb_g[cb] + cr_g[cr]) >> 16));
      o[2] = clamp255(yy + cb_b[cb]);
    }
  return 0;
}
