// Radix-4 soft Viterbi for the 64-state K=7 802.11 BCC. CUDA C++ for sm_90a.
//
// Replaces the TPU kernel ieee80211_tpu/ops/pallas/viterbi.py (_kernel :70,
// _build_call :263, wrapper viterbi_decode_pallas :311). The semantics are
// the ones that kernel and ieee80211_tpu/ops/coding.py fix:
//   * one block fuses k = 4 trellis steps; state s has 16 candidate
//     predecessors ((s mod 4) << 4) | p, p = 0..15 (coding._radix_tables);
//   * the branch metric is the sum of the LLRs whose coded bit is 1 on that
//     path, taken in the order step j = 0..3, then coded bit c = 0, 1;
//   * candidate = path metric + branch metric, in one add; the max is a
//     scan over p = 0..15 with a strict >, so ties keep the lower path;
//   * float32 metrics minus their max over states every `renorm` blocks, at
//     block t with t % renorm == renorm - 1;
//   * traceback from the first state of maximal final metric;
//   * NaN is the greatest value, and the first NaN wins a max, as
//     torch.max, amax and argmax order them in the plain version.
// Built with -fmad=false. With these rules the kernel equals the plain
// PyTorch version (ops/coding.py::viterbi_pairs_plain) bit for bit.
//
// What bounds it on the H100: the trellis is sequential in t, so per block
// every packet adds, compares and selects 64 x 16 candidates, each needing
// its branch metric; the bytes (32 B of LLRs in, 16 B of bits out and 32 B
// of survivors per packet per block) are small beside that work. Taking
// each part out on the card (perf/viterbi_ablate.py) shows the
// compare-selects, the branch-metric loads and the table build each cost
// about a quarter of the time and the traceback a tenth: instruction issue
// and shared-memory traffic together, not bytes.
//
// The design, one warp per packet, no barrier wider than a warp:
//   * lane l holds states l and l + 32. Both have the predecessors
//     16 (l mod 4) .. +15, read as four 16-byte shared loads that the lanes
//     with the same l mod 4 share (states 32..63 sit 4 floats further on, so
//     the four groups fall on distinct banks);
//   * a branch-metric table per block: the 256 sums of the 8 LLRs, one per
//     8-bit mask m of coded bits. Lane l forms the sum of its low 5 mask
//     bits (l) in ascending order, then adds bits 5, 6 and 7 in that order
//     for its 8 entries m = l + 32h. Adding an unselected LLR in the plain
//     version adds +0.0, which changes nothing: the running sum starts at
//     +0.0 and cannot become -0.0, so every entry is the plain version's
//     branch metric bit for bit. A candidate is then one shared load, one
//     add and one compare-select, where the plain sum is 8 selects and adds;
//   * entry m sits at 4 (m mod 32) + 128 (m >> 7) + ((m >> 5) mod 4), so a
//     lane stores its 8 entries as two 16-byte stores, and the candidates'
//     loads (mask L(s) ^ R(p): the code is linear) fall on 32 distinct
//     banks for every p in both halves of the states;
//   * the next block's entries are summed before this block's ACS and
//     stored after its loads: table and path metrics are double-buffered in
//     shared memory, with one __syncwarp per block; the renorm max is a warp
//     shuffle reduction (fmaxf ignores order, so it equals the serial max);
//   * LLRs read 32 blocks at a time, lane l loading block 32c + l into
//     registers a chunk ahead and staging it into shared memory, from where
//     every lane reads a block's 8 LLRs as two broadcast 16-byte loads;
//   * survivors 4 bits per state per block: lane l packs the nibbles of its
//     two states for 4 blocks into one word and stores it every 4 blocks,
//     one 128-byte row per warp ([B, ceil(n_blk / 4), 32] words);
//   * traceback by the whole warp: each lane loads 8 words (32 blocks) of a
//     chunk, the next chunk's loads in flight; every lane follows the same
//     state, taking the survivor word from lane (state mod 32) by shuffle;
//     lane l keeps the state of block 32c + l and writes its 4 bits as one
//     16-byte store, so a chunk's bits leave as 512 contiguous bytes;
//   * one warp per thread block, so even a small batch spreads over every
//     SM;
//   * NaN metrics arise only from LLRs that are not finite or of magnitude
//     kBig or more: the path metrics of smaller ones stay far below
//     float32's range, since any state reaches any other within two blocks.
//     A first pass over the packet's LLRs flags such a packet, and only
//     it runs the NaN-ordering compares (kNan): a junk window, e.g. one
//     whose channel estimate divides by zero.
// No tensor cores, no reduced-precision metrics: the result stays bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 4;                   // trellis steps per block
constexpr int kPaths = 1 << kK;         // candidate predecessors per state
constexpr int kStates = 64;
constexpr int kLow = kStates / kPaths;  // predecessor bits kept from s
constexpr int kChunk = 32;              // blocks per LLR / traceback chunk
constexpr int kGroups = kChunk / 4;     // survivor words per lane per chunk
constexpr int kTable = 256;             // one sum per 8-bit coded-bit mask
constexpr int kPm = kStates + 4;        // padded path-metric row
constexpr float kNeg = -1e30f;          // ops/coding.py NEG
constexpr float kBig = 1e30f;           // LLRs below it keep metrics finite
constexpr unsigned kAll = 0xffffffffu;

// states 32..63 sit 4 floats on, so that the predecessor groups of the four
// values of l mod 4 start on banks 0, 16, 4 and 20
__device__ __forceinline__ int pm_at(int s) { return s + ((s >> 5) << 2); }

// where branch metric m sits in its table
__device__ __forceinline__ int table_at(int m) {
  return 4 * (m & 31) + 128 * (m >> 7) + ((m >> 5) & 3);
}

struct __align__(16) WarpShared {
  float table[2][kTable];
  float pm[2][kPm];
  float4 llr[2][kChunk][2];   // two chunks of 32 blocks x 8 LLRs
};

// The 8-bit coded-bit mask of one (state, path) of the radix tables
// w0, w1 [64, 16, 4] float32 (coding._radix_tables(4)): bit 2j + c is set
// where coded bit c of step j is 1.
__device__ __forceinline__ int coded_mask(const float4* __restrict__ w0,
                                          const float4* __restrict__ w1,
                                          int row) {
  const float4 c0 = __ldg(w0 + row);
  const float4 c1 = __ldg(w1 + row);
  return (c0.x != 0.0f) | (c1.x != 0.0f) << 1 | (c0.y != 0.0f) << 2 |
         (c1.y != 0.0f) << 3 | (c0.z != 0.0f) << 4 | (c1.z != 0.0f) << 5 |
         (c0.w != 0.0f) << 6 | (c1.w != 0.0f) << 7;
}

__device__ __forceinline__ void load_llr_chunk(const float4* llr, int chunk,
                                               int n_blk, int lane,
                                               float4& a, float4& b) {
  const int t = chunk * kChunk + lane;
  if (t < n_blk) {
    a = __ldg(llr + 2 * (size_t)t);
    b = __ldg(llr + 2 * (size_t)t + 1);
  } else {
    a = b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// This lane's 8 branch metrics m = lane + 32h of the block whose LLRs are
// (a, b), as the two 16-byte rows h = 0..3 and h = 4..7 of table_at.
__device__ __forceinline__ void table_rows(float4 a, float4 b, int lane,
                                           float4& lo, float4& hi) {
  float x = 0.0f;
  if (lane & 1) x = x + a.x;
  if (lane & 2) x = x + a.y;
  if (lane & 4) x = x + a.z;
  if (lane & 8) x = x + a.w;
  if (lane & 16) x = x + b.x;
  const float x5 = x + b.y;
  const float x6 = x + b.z;
  const float x56 = x5 + b.z;
  lo = make_float4(x, x5, x6, x56);
  hi = make_float4(x + b.w, x5 + b.w, x6 + b.w, x56 + b.w);
}

__device__ __forceinline__ void load_dec_chunk(const uint32_t* dec, int chunk,
                                               int n_grp, int lane,
                                               uint32_t (&w)[kGroups]) {
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int g = chunk * kGroups + k;
    w[k] = g < n_grp ? dec[(size_t)g * 32 + lane] : 0u;
  }
}

// c beats the best so far: a strict >, so a tie keeps the lower path; with
// kNan, a NaN beats every number and no later NaN beats it (torch.max).
template <bool kNan>
__device__ __forceinline__ bool beats(float c, float best) {
  return kNan ? (c > best || (c != c && best == best)) : c > best;
}

// The larger of a and b; with kNan, NaN if either is (torch.amax). Either
// way the order of a reduction does not change its result.
template <bool kNan>
__device__ __forceinline__ float max2(float a, float b) {
  return kNan ? ((a > b || a != a) ? a : b) : fmaxf(a, b);
}

// The best of the 16 candidates pv[p] + tv[p] and its path.
template <bool kNan>
__device__ __forceinline__ void best_of(const float (&pv)[kPaths],
                                        const float (&tv)[kPaths],
                                        float& best, int& arg) {
  best = pv[0] + tv[0];
  arg = 0;
#pragma unroll
  for (int p = 1; p < kPaths; ++p) {
    const float c = pv[p] + tv[p];
    if (beats<kNan>(c, best)) {
      best = c;
      arg = p;
    }
  }
}

// What one block of the trellis carries to the next, besides shared memory.
struct Carry {
  uint32_t word;      // survivor nibbles of the current group of 4 blocks
  int since_renorm;   // blocks since the last renorm
  float4 na, nb;      // LLRs of block 32c + lane of the next chunk, in flight
};

// Block t of one packet; kCur = t & 1 picks the double buffers, so every
// shared address is a register plus an immediate.
template <int kCur, bool kNan>
__device__ __forceinline__ void acs_block(
    WarpShared& sh, const int (&idx0)[kPaths], const int (&idx1)[kPaths],
    int pred, int t, int n_blk, int renorm, int lane, const float4* llr,
    uint32_t* dec_b, Carry& cr) {
  const float4* pm4 = reinterpret_cast<const float4*>(&sh.pm[kCur][pred]);
  float pv[kPaths];
#pragma unroll
  for (int i = 0; i < kPaths / 4; ++i) {
    const float4 v = pm4[i];
    pv[4 * i] = v.x;
    pv[4 * i + 1] = v.y;
    pv[4 * i + 2] = v.z;
    pv[4 * i + 3] = v.w;
  }
  float tv0[kPaths], tv1[kPaths];
#pragma unroll
  for (int p = 0; p < kPaths; ++p) {
    tv0[p] = sh.table[kCur][idx0[p]];
    tv1[p] = sh.table[kCur][idx1[p]];
  }
  // the next block's branch metrics, summed while this block's loads fly
  const int u = t + 1;
  const bool more = u < n_blk;
  float4 lo, hi;
  if (more) {
    const int c = u / kChunk;
    if ((u & (kChunk - 1)) == 0) {   // stage chunk c; fetch chunk c + 1
      sh.llr[c & 1][lane][0] = cr.na;
      sh.llr[c & 1][lane][1] = cr.nb;
      load_llr_chunk(llr, c + 1, n_blk, lane, cr.na, cr.nb);
      __syncwarp();
    }
    table_rows(sh.llr[c & 1][u & (kChunk - 1)][0],
               sh.llr[c & 1][u & (kChunk - 1)][1], lane, lo, hi);
  }
  float best0, best1;
  int arg0, arg1;
  best_of<kNan>(pv, tv0, best0, arg0);
  best_of<kNan>(pv, tv1, best1, arg1);
  if (more) {
    float4* next = reinterpret_cast<float4*>(sh.table[kCur ^ 1]);
    next[lane] = lo;
    next[32 + lane] = hi;
  }
  if (++cr.since_renorm == renorm) {
    cr.since_renorm = 0;
    float mx = max2<kNan>(best0, best1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = max2<kNan>(mx, __shfl_xor_sync(kAll, mx, off));
    best0 = best0 - mx;
    best1 = best1 - mx;
  }
  sh.pm[kCur ^ 1][pm_at(lane)] = best0;
  sh.pm[kCur ^ 1][pm_at(lane + 32)] = best1;
  cr.word |= (uint32_t)(arg0 | (arg1 << 4)) << (8 * (t & 3));
  if ((t & 3) == 3 || t == n_blk - 1) {
    dec_b[(size_t)(t >> 2) * 32 + lane] = cr.word;
    cr.word = 0;
  }
  __syncwarp();   // also orders the survivor stores before the traceback
}

// Every block of one packet.
template <bool kNan>
__device__ __forceinline__ void trellis(WarpShared& sh,
                                        const int (&idx0)[kPaths],
                                        const int (&idx1)[kPaths], int pred,
                                        int n_blk, int renorm, int lane,
                                        const float4* llr, uint32_t* dec_b,
                                        Carry& cr) {
  for (int t = 0; t < n_blk; t += 2) {
    acs_block<0, kNan>(sh, idx0, idx1, pred, t, n_blk, renorm, lane, llr,
                       dec_b, cr);
    if (t + 1 < n_blk)
      acs_block<1, kNan>(sh, idx0, idx1, pred, t + 1, n_blk, renorm, lane,
                         llr, dec_b, cr);
  }
}

__global__ void __launch_bounds__(32)
viterbi_r4_kernel(const float* __restrict__ lp,       // [B, n_blk, 2k]
                  const float4* __restrict__ w0,      // [64, 16] x k
                  const float4* __restrict__ w1,      // [64, 16] x k
                  uint32_t* __restrict__ dec,         // [B, n_grp, 32]
                  int32_t* __restrict__ bits,         // [B, n_blk * k]
                  int n_blk, int renorm) {
  __shared__ WarpShared sh;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int n_grp = (n_blk + 3) >> 2;
  const float4* llr =
      reinterpret_cast<const float4*>(lp + (size_t)b * n_blk * 2 * kK);
  uint32_t* dec_b = dec + (size_t)b * n_grp * 32;

  // where candidate p of each of the lane's two states finds its branch
  // metric: the table slot of its coded-bit mask
  int idx0[kPaths], idx1[kPaths];
#pragma unroll
  for (int p = 0; p < kPaths; ++p) {
    idx0[p] = table_at(coded_mask(w0, w1, lane * kPaths + p));
    idx1[p] = table_at(coded_mask(w0, w1, (lane + 32) * kPaths + p));
  }
  const int pred = pm_at((lane & (kLow - 1)) << kK);
  // whether an LLR of this packet can make a metric NaN (the compare of
  // |x| < kBig is false for NaN)
  bool odd = false;
  for (int i = lane; i < 2 * n_blk; i += 32) {
    const float4 v = __ldg(llr + i);
    odd |= !(fabsf(v.x) < kBig) | !(fabsf(v.y) < kBig) |
           !(fabsf(v.z) < kBig) | !(fabsf(v.w) < kBig);
  }
  const bool nan_path = __any_sync(kAll, odd);

  sh.pm[0][pm_at(lane)] = lane == 0 ? 0.0f : kNeg;
  sh.pm[0][pm_at(lane + 32)] = kNeg;
  Carry cr;
  cr.word = 0;
  cr.since_renorm = 0;
  {
    float4 a, c;
    load_llr_chunk(llr, 0, n_blk, lane, a, c);
    sh.llr[0][lane][0] = a;
    sh.llr[0][lane][1] = c;
    load_llr_chunk(llr, 1, n_blk, lane, cr.na, cr.nb);
    __syncwarp();
    float4 lo, hi;
    table_rows(sh.llr[0][0][0], sh.llr[0][0][1], lane, lo, hi);
    reinterpret_cast<float4*>(sh.table[0])[lane] = lo;
    reinterpret_cast<float4*>(sh.table[0])[32 + lane] = hi;
    __syncwarp();
  }
  if (nan_path)
    trellis<true>(sh, idx0, idx1, pred, n_blk, renorm, lane, llr, dec_b, cr);
  else
    trellis<false>(sh, idx0, idx1, pred, n_blk, renorm, lane, llr, dec_b,
                   cr);

  // the first state of maximal final metric, as a serial scan in every lane
  const float* fin = sh.pm[n_blk & 1];
  int state = 0;
  float m = fin[0];
  for (int i = 1; i < kStates; ++i) {
    const float v = fin[pm_at(i)];
    if (beats<true>(v, m)) {
      m = v;
      state = i;
    }
  }

  int4* out = reinterpret_cast<int4*>(bits + (size_t)b * n_blk * kK);
  const int last = (n_blk - 1) / kChunk;
  uint32_t wc[kGroups], wn[kGroups];
  load_dec_chunk(dec_b, last, n_grp, lane, wc);
  if (last > 0) load_dec_chunk(dec_b, last - 1, n_grp, lane, wn);
  int mine = 0;   // the state after block 32c + lane
  for (int c = last; c >= 0; --c) {
#pragma unroll
    for (int k = kChunk - 1; k >= 0; --k) {
      const int t = c * kChunk + k;
      if (t < n_blk) {
        if (lane == k) mine = state;
        const uint32_t wd = __shfl_sync(kAll, wc[k >> 2], state & 31);
        const int d = (wd >> ((8 * (k & 3)) | ((state >> 3) & 4))) & 0xf;
        state = ((state & (kLow - 1)) << kK) | d;
      }
    }
    const int t = c * kChunk + lane;
    if (t < n_blk)
      out[t] = make_int4((mine >> 2) & 1, (mine >> 3) & 1, (mine >> 4) & 1,
                         (mine >> 5) & 1);
#pragma unroll
    for (int k = 0; k < kGroups; ++k) wc[k] = wn[k];
    if (c >= 2) load_dec_chunk(dec_b, c - 2, n_grp, lane, wn);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted). lp, w0, w1 and bits must be 16-byte aligned, and dec must hold
// batch * ceil(n_blk / 4) * 32 words (checked by the wrapper).
extern "C" int viterbi_r4_launch(const void* lp, const void* w0,
                                 const void* w1, void* dec, void* bits,
                                 int batch, int n_blk, int renorm,
                                 void* stream) {
  viterbi_r4_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const float4*>(w0),
      static_cast<const float4*>(w1), static_cast<uint32_t*>(dec),
      static_cast<int32_t*>(bits), n_blk, renorm);
  return static_cast<int>(cudaGetLastError());
}
