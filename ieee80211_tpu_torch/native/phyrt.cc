// Native host runtime for ieee80211_tpu; the port's version of
// ieee80211_tpu/native/phyrt.cc: the same C interface and the same results
// (tests/test_torch_native.py holds the two libraries' results equal), with
// the trigger scan and the int8 quantization rewritten to run wide.
//
// The TPU executes the batched PHY math; this library owns the host-side
// streaming/byte-level runtime that the reference implements as C++ GNU
// Radio blocks (SURVEY.md §2.1): the O(N) per-sample trigger scan over
// captures (trigger_impl.cc:75-110 analog), FCS CRC-32, the A-MPDU
// delimiter walk (decode_impl.cc:329-427 analog) and LSB-first bit packing.
// Exposed as a plain C ABI consumed via ctypes
// (ieee80211_tpu_torch/native/lib.py).
//
// Built by lib.py at first use into ieee80211_tpu_torch/_build/libphyrt.so.

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>

namespace {

// Positions per block of the trigger scan's precomputed steps (4 doubles
// a position: 8 KiB, in L1 beside the capture's stream).
constexpr int64_t kScanBlock = 256;

// 16 floats, for the loops that GCC does not vectorise on its own.
typedef float f32x16 __attribute__((vector_size(64)));
typedef int32_t i32x16 __attribute__((vector_size(64)));

// The trigger scan's steps for positions b <= i < e: what step i adds to
// the lag correlation (cr, ci) and to the two powers (d1, d2), at index
// i - b. Each product of two float32 values is exact in float64, so each
// term here is rounded once where std::complex's product rounds it,
// however the compiler contracts it, and the loop, which carries no
// dependence, runs wide. A non-finite input, which std::complex's
// multiply handles on a path of its own, makes cr non-finite: such steps
// are taken again through std::complex.
void scan_steps(const float* iq, int64_t b, int64_t e, int lag, int win,
                double* cr, double* ci, double* d1, double* d2) {
  const int64_t len = e - b;
  const float* o = iq + 2 * b;
  const float* l = iq + 2 * (b + lag);
  const float* w = iq + 2 * (b + win);
  const float* m = iq + 2 * (b + win + lag);
  for (int64_t j = 0; j < len; ++j) {
    const double orr = o[2 * j], oi = o[2 * j + 1];
    const double lr = l[2 * j], li = l[2 * j + 1];
    const double nr = w[2 * j], ni = w[2 * j + 1];
    const double mr = m[2 * j], mi = m[2 * j + 1];
    // xn * conj(xm) - xo * conj(xl); norm(xn) - norm(xo); norm(xm) - norm(xl)
    cr[j] = (nr * mr + ni * mi) - (orr * lr + oi * li);
    ci[j] = (ni * mr - nr * mi) - (oi * lr - orr * li);
    d1[j] = (nr * nr + ni * ni) - (orr * orr + oi * oi);
    d2[j] = (mr * mr + mi * mi) - (lr * lr + li * li);
  }
  int bad = 0;
  for (int64_t j = 0; j < len; ++j) bad |= !std::isfinite(cr[j]);
  if (!bad) return;
  const std::complex<float>* x =
      reinterpret_cast<const std::complex<float>*>(iq);
  for (int64_t j = 0; j < len; ++j) {
    if (std::isfinite(cr[j])) continue;
    const int64_t i = b + j;
    const std::complex<double> xo(x[i]), xl(x[i + lag]);
    const std::complex<double> xn(x[i + win]), xm(x[i + win + lag]);
    const std::complex<double> d = xn * std::conj(xm) - xo * std::conj(xl);
    cr[j] = d.real();
    ci[j] = d.imag();
    d1[j] = std::norm(xn) - std::norm(xo);
    d2[j] = std::norm(xm) - std::norm(xl);
  }
}

// Peak |re| / |im| over m floats (at least 1e-12; a NaN is never larger),
// then each value scaled to +-126 at the peak, clamped to +-127 and rounded
// half to even, as lrintf rounds in the default mode; a NaN gives 0, the
// low byte of lrintf's out-of-range result. Returns the dequantization
// scale (peak / 126). Both loops run wide: no libm call per value.
float quantize_pass(const float* iq, int64_t m, int8_t* q) {
  // 16 running maxima, then the rest; the maximum of |values| does not
  // depend on the order it is taken in
  f32x16 pk = f32x16{} + 1e-12f;
  int64_t i = 0;
  for (; i + 16 <= m; i += 16) {
    f32x16 a;
    std::memcpy(&a, iq + i, sizeof a);
    a = (f32x16)((i32x16)a & 0x7fffffff);
    pk = a > pk ? a : pk;
  }
  float peak = 1e-12f;
  for (int k = 0; k < 16; ++k) peak = pk[k] > peak ? pk[k] : peak;
  for (; i < m; ++i) {
    const float a = std::fabs(iq[i]);
    peak = a > peak ? a : peak;
  }
  const float s = 126.0f / peak;
  for (i = 0; i < m; ++i) {
    float v = iq[i] * s;
    v = v < -127.0f ? -127.0f : (v > 127.0f ? 127.0f : v);
    q[i] = v == v ? (int8_t)(int32_t)std::nearbyint(v) : 0;
  }
  return peak / 126.0f;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// STF trigger scan: sliding lag-correlation with plateau detection.
// lag = STF period in samples (16 at 20 MHz, scaled by the oversample
// factor for 40/80 MHz captures); the averaging window equals the lag.
// iq: interleaved float32 (re, im) * n. Returns number of triggers written.
// The per-sample terms are computed a block ahead (scan_steps); only the
// four float64 running sums, added in sample order, and the plateau logic
// run serially.
// ---------------------------------------------------------------------------
int64_t phyrt_find_triggers_lag(const float* iq, int64_t n, float thresh,
                                int32_t plateau, int32_t min_gap,
                                int32_t lag, int64_t* out, int64_t max_out) {
  const int LAG = lag, WIN = lag;
  if (lag <= 0 || n < LAG + WIN + 1 || max_out <= 0) return 0;
  const std::complex<float>* x =
      reinterpret_cast<const std::complex<float>*>(iq);
  std::complex<double> acc(0.0, 0.0);
  double p1 = 0.0, p2 = 0.0;
  for (int i = 0; i < WIN; ++i) {
    acc += std::complex<double>(x[i]) * std::conj(std::complex<double>(x[i + LAG]));
    p1 += std::norm(std::complex<double>(x[i]));
    p2 += std::norm(std::complex<double>(x[i + LAG]));
  }
  int64_t n_out = 0;
  int32_t run = 0;
  int64_t last = -(int64_t)min_gap;
  const int64_t n_pos = n - LAG - WIN + 1;
  const double t2 = (double)thresh * (double)thresh;
  double cr[kScanBlock], ci[kScanBlock], d1[kScanBlock], d2[kScanBlock];
  for (int64_t b = 0; b < n_pos; b += kScanBlock) {
    const int64_t e = std::min(b + kScanBlock, n_pos);
    // the last position compares and takes no step
    const int64_t e_step = std::min(e, n_pos - 1);
    scan_steps(iq, b, e_step, LAG, WIN, cr, ci, d1, d2);
    for (int64_t i = b; i < e; ++i) {
      // |acc| / sqrt(p1*p2) > thresh  <=>  |acc|^2 > thresh^2 * p1 * p2
      // (squared compare: no per-sample hypot/sqrt). Rolling-sum drift
      // can make p1/p2 slightly negative in long silent regions; clamp so
      // the RHS never goes negative (a negative RHS would let any tiny
      // |acc|^2 fire spurious plateau triggers — the sqrt form yielded
      // NaN -> false).
      const double pp = (p1 > 0.0 && p2 > 0.0) ? p1 * p2 : 0.0;
      if (std::norm(acc) > t2 * pp + 1e-24) {
        if (++run == plateau) {
          const int64_t s = i - plateau + 1;
          if (s - last >= min_gap) {
            out[n_out++] = s;
            last = s;
            if (n_out >= max_out) return n_out;
          }
        }
      } else {
        run = 0;
      }
      if (i < e_step) {
        acc += std::complex<double>(cr[i - b], ci[i - b]);
        p1 += d1[i - b];
        p2 += d2[i - b];
      }
    }
  }
  return n_out;
}

int64_t phyrt_find_triggers(const float* iq, int64_t n, float thresh,
                            int32_t plateau, int32_t min_gap,
                            int64_t* out, int64_t max_out) {
  return phyrt_find_triggers_lag(iq, n, thresh, plateau, min_gap, 16, out,
                                 max_out);
}

// ---------------------------------------------------------------------------
// CRC-32 (IEEE 802.3 / zlib polynomial, reflected)
// ---------------------------------------------------------------------------
static uint32_t crc_tab[256];
static bool crc_init_done = false;
static void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0xEDB88320u : 0u);
    crc_tab[i] = c;
  }
  crc_init_done = true;
}

uint32_t phyrt_crc32(const uint8_t* data, int64_t n) {
  if (!crc_init_done) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) c = crc_tab[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// LSB-first bit packing: bits[i] in {0,1} -> bytes
// ---------------------------------------------------------------------------
void phyrt_pack_bits(const uint8_t* bits, int64_t n_bits, uint8_t* out) {
  const int64_t n_bytes = n_bits / 8;
  for (int64_t i = 0; i < n_bytes; ++i) {
    uint8_t b = 0;
    for (int j = 0; j < 8; ++j) b |= (bits[i * 8 + j] & 1) << j;
    out[i] = b;
  }
}

// ---------------------------------------------------------------------------
// A-MPDU delimiter walk (VHT: 14-bit length; HT: 12-bit length).
// Returns subframe count; offsets/lengths/fcs_ok arrays are filled.
// ---------------------------------------------------------------------------
static int crc8_bits_ok(const uint8_t* d) {
  // delimiter CRC-8 over the first 16 bits, compared with bits 16..23
  uint8_t c[8];
  for (int i = 0; i < 8; ++i) c[i] = 1;
  for (int bi = 0; bi < 16; ++bi) {
    const uint8_t b = (d[bi / 8] >> (bi % 8)) & 1;
    uint8_t nc[8];
    nc[0] = b ^ c[7];
    nc[1] = b ^ c[7] ^ c[0];
    nc[2] = b ^ c[7] ^ c[1];
    nc[3] = c[2];
    nc[4] = c[3];
    nc[5] = c[4];
    nc[6] = c[5];
    nc[7] = c[6];
    std::memcpy(c, nc, 8);
  }
  for (int i = 0; i < 8; ++i) {
    const uint8_t expect = 1 - c[7 - i];
    const uint8_t got = (d[2] >> i) & 1;
    if (expect != got) return 0;
  }
  return 1;
}

int64_t phyrt_deagg(const uint8_t* psdu, int64_t n, int32_t vht,
                    int64_t* offsets, int64_t* lengths, uint8_t* fcs_ok,
                    int64_t max_sub) {
  if (!crc_init_done) crc_init();
  int64_t i = 0, count = 0;
  while (i + 4 <= n && count < max_sub) {
    const uint8_t* d = psdu + i;
    if (d[3] != 0x4E) break;
    if (!crc8_bits_ok(d)) break;
    int64_t mlen = 0;
    for (int k = 0; k < 12; ++k) mlen |= (int64_t)((d[(4 + k) / 8] >> ((4 + k) % 8)) & 1) << k;
    if (vht) {
      mlen |= (int64_t)((d[0] >> 2) & 1) << 12;
      mlen |= (int64_t)((d[0] >> 3) & 1) << 13;
    }
    if (mlen == 0) { i += 4; continue; }
    if (i + 4 + mlen > n) break;
    const uint8_t* mpdu = psdu + i + 4;
    uint8_t ok = 0;
    if (mlen > 4) {
      const uint32_t want = (uint32_t)mpdu[mlen - 4] |
                            ((uint32_t)mpdu[mlen - 3] << 8) |
                            ((uint32_t)mpdu[mlen - 2] << 16) |
                            ((uint32_t)mpdu[mlen - 1] << 24);
      ok = phyrt_crc32(mpdu, mlen - 4) == want;
    }
    offsets[count] = i + 4;
    lengths[count] = mlen;
    fcs_ok[count] = ok;
    ++count;
    i += 4 + mlen;
    if (i % 4) i += 4 - (i % 4);
  }
  return count;
}

// ---------------------------------------------------------------------------
// Capture ingest: STF trigger scan + int8 quantization for device ingest,
// one call per capture. Returns the trigger count; *scale_out receives the
// dequantization scale (peak / 126), and q_out (2*n int8) values identical
// to phyrt_quantize_int8's, so decode_capture and decode_captures produce
// bit-identical quantized inputs.
// ---------------------------------------------------------------------------
int64_t phyrt_scan_quantize(const float* iq, int64_t n, float thresh,
                            int32_t plateau, int32_t min_gap, int32_t lag,
                            int64_t* out, int64_t max_out, int8_t* q_out,
                            float* scale_out) {
  *scale_out = quantize_pass(iq, 2 * n, q_out);
  return phyrt_find_triggers_lag(iq, n, thresh, plateau, min_gap, lag, out,
                                 max_out);
}

// int8 capture quantization for device ingest (quantize_pass); out must
// hold 2*n int8.
float phyrt_quantize_int8(const float* iq, int64_t n, int8_t* out) {
  return quantize_pass(iq, 2 * n, out);
}

}  // extern "C"
