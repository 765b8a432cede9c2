// Radix-4 soft Viterbi for the 64-state K=7 802.11 BCC. CUDA C++ for sm_90a.
//
// Replaces the TPU kernel ieee80211_tpu/ops/pallas/viterbi.py (_kernel :70,
// _build_call :263, wrapper viterbi_decode_pallas :311). The semantics are
// the ones that kernel and ieee80211_tpu/ops/coding.py fix:
//   * one block fuses k = 4 trellis steps; state s has 16 candidate
//     predecessors ((s mod 4) << 4) | p, p = 0..15 (coding._radix_tables);
//   * the branch metric is the sum of the LLRs whose coded bit is 1 on that
//     path, taken in the order step j = 0..3, then coded bit c = 0, 1, with
//     selects and adds;
//   * candidate = path metric + branch metric, in one add; the max uses a
//     strict >, so ties keep the lower path index (as the TPU tournament and
//     jnp.argmax do);
//   * float32 metrics minus their max over states every `renorm` blocks, at
//     block t with t % renorm == renorm - 1;
//   * traceback from the first state of maximal final metric.
// Built with -fmad=false. With these rules the kernel equals the plain
// PyTorch version (ops/coding.py::viterbi_pairs_plain) bit for bit.
//
// What bounds it on the H100: the trellis is sequential, so the time is the
// latency of one add-compare-select block (16 candidates x 8 selected adds
// per state, then one barrier) times the number of blocks, hidden only by
// the packets in flight; and the survivor bytes, 64 per packet per block
// (77 MB at batch 1024 x 4680 bits). The TPU kept survivors in VMEM; here a
// 33000-bit trellis would need ~264 KB per packet, more than the 227 KB of
// shared memory a block can have.
// What this simple design does about it: one thread per state and four
// packets per 256-thread block, so batch 1024 gives 256 independent blocks
// for the 132 SMs; path metrics double-buffered in shared memory, so one
// barrier per block of 4 steps; survivors written coalesced to device memory
// (64 consecutive bytes per packet per block), and read back by a
// one-thread-per-packet traceback at the end of the same kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 4;                     // trellis steps per block
constexpr int kPaths = 1 << kK;           // candidate predecessors per state
constexpr int kStates = 64;
constexpr int kLow = kStates / kPaths;    // predecessor bits kept from s
constexpr int kPackets = 4;               // packets per thread block
constexpr float kNeg = -1e30f;            // ops/coding.py NEG

__global__ void __launch_bounds__(kStates * kPackets)
viterbi_r4_kernel(const float* __restrict__ lp,       // [B, n_blk, 2k]
                  const uint8_t* __restrict__ masks,  // [64, 16]
                  uint8_t* __restrict__ dec,          // [B, n_blk, 64]
                  int32_t* __restrict__ bits,         // [B, n_blk * k]
                  int batch, int n_blk, int renorm) {
  __shared__ float pm[2][kPackets][kStates];
  const int s = threadIdx.x;
  const int w = threadIdx.y;
  const int b = blockIdx.x * kPackets + w;
  const bool live = b < batch;   // rows past the batch still join barriers

  // bit (2j + c) of mask[p]: coded bit c of step j on path p into s is 1
  uint8_t mask[kPaths];
#pragma unroll
  for (int p = 0; p < kPaths; ++p) mask[p] = masks[s * kPaths + p];
  const int pred_base = (s & (kLow - 1)) << kK;

  const size_t row = live ? (size_t)b : 0;
  const float* llr = lp + row * n_blk * 2 * kK;
  uint8_t* dec_b = dec + row * n_blk * kStates;

  pm[0][w][s] = (s == 0) ? 0.0f : kNeg;
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < n_blk; ++t) {
    float l[2 * kK];
#pragma unroll
    for (int i = 0; i < 2 * kK; ++i)
      l[i] = live ? __ldg(llr + (size_t)t * 2 * kK + i) : 0.0f;
    float best = 0.0f;
    int arg = 0;
#pragma unroll
    for (int p = 0; p < kPaths; ++p) {
      float bm = 0.0f;
#pragma unroll
      for (int i = 0; i < 2 * kK; ++i)
        bm = bm + (((mask[p] >> i) & 1) ? l[i] : 0.0f);
      const float cand = pm[cur][w][pred_base | p] + bm;
      if (p == 0 || cand > best) {
        best = cand;
        arg = p;
      }
    }
    const int nxt = cur ^ 1;
    pm[nxt][w][s] = best;
    if (live) dec_b[(size_t)t * kStates + s] = (uint8_t)arg;
    __syncthreads();
    if (t % renorm == renorm - 1) {
      float mx = pm[nxt][w][0];
      for (int i = 1; i < kStates; ++i) mx = fmaxf(mx, pm[nxt][w][i]);
      __syncthreads();
      pm[nxt][w][s] = best - mx;
      __syncthreads();
    }
    cur = nxt;
  }

  // The barrier at the end of the last block makes every thread's survivor
  // stores visible to this packet's traceback thread.
  if (s == 0 && live) {
    int state = 0;
    float m = pm[cur][w][0];
    for (int i = 1; i < kStates; ++i) {
      if (pm[cur][w][i] > m) {
        m = pm[cur][w][i];
        state = i;
      }
    }
    int32_t* out = bits + (size_t)b * n_blk * kK;
    for (int t = n_blk - 1; t >= 0; --t) {
      const int d = dec_b[(size_t)t * kStates + state];
#pragma unroll
      for (int j = 0; j < kK; ++j)
        out[(size_t)t * kK + j] = (state >> (6 - kK + j)) & 1;
      state = ((state & (kLow - 1)) << kK) + d;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int viterbi_r4_launch(const void* lp, const void* masks, void* dec,
                                 void* bits, int batch, int n_blk, int renorm,
                                 void* stream) {
  const dim3 block(kStates, kPackets);
  const dim3 grid((batch + kPackets - 1) / kPackets);
  viterbi_r4_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const uint8_t*>(masks),
      static_cast<uint8_t*>(dec), static_cast<int32_t*>(bits), batch, n_blk,
      renorm);
  return static_cast<int>(cudaGetLastError());
}
