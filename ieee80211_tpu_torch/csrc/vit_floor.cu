// Floor probe of the radix-4 Viterbi kernel (csrc/viterbi.cu). CUDA C++ for
// sm_90a.
//
// Replaces the TPU probe perf_vit_floor.py::main (kernel :14, pallas_call
// :37): the Viterbi kernel's skeleton with its add-compare-select taken out,
// so that the difference between the two kernels' times on the same input
// is what the ACS, the survivors and the traceback cost on this card. Like
// the TPU probe it stores no survivors and does no traceback.
//
// The skeleton is viterbi.cu's (its design note, points 1, 5 and 7):
//   * one warp per packet, one warp per thread block, so even a small batch
//     spreads over every SM;
//   * lane l holds states l and l + 32, their path metrics double-buffered
//     in shared memory (the same padded rows), one __syncwarp per block;
//   * LLRs [B, n_blk, 8] float32 read 32 blocks at a time, lane l loading
//     block 32c + l into registers a chunk ahead and staging it into shared
//     memory, from where every lane reads a block's 8 LLRs as two broadcast
//     16-byte loads;
//   * two blocks per loop trip, so every shared address is a register plus
//     an immediate.
// Taken out: the branch-metric table build, the candidates' table and
// predecessor loads, the compare-selects and the renorm, and the first pass
// over the LLRs that flags non-finite ones. Per block each state does
//   m = (m + sum(llr of this block) * 1e-30f) + 1.0f
// with the sum taken over the 8 LLRs in order (perf_vit_floor.py:30; built
// with -fmad=false), so every output entry is n_blk. Output int32 [B, 64],
// packet-major as viterbi.cu.
//
// What bounds it on the H100: the per-block latency of one warp's chain of
// shared-memory loads, adds, stores and warp barrier, times n_blk; the LLR
// bytes (32 per packet per block, 38 MB at 1024 x 1176 blocks) are small
// beside it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 4;          // trellis steps per block, as viterbi.cu
constexpr int kStates = 64;
constexpr int kChunk = 32;     // blocks per LLR chunk
constexpr int kPm = kStates + 4;
constexpr float kScale = 1e-30f;

// as viterbi.cu: states 32..63 sit 4 floats on
__device__ __forceinline__ int pm_at(int s) { return s + ((s >> 5) << 2); }

struct __align__(16) WarpShared {
  float pm[2][kPm];
  float4 llr[2][kChunk][2];   // two chunks of 32 blocks x 8 LLRs
};

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

// Block t of one packet; kCur = t & 1 picks the metrics' buffers.
template <int kCur>
__device__ __forceinline__ void floor_block(WarpShared& sh, int t, int n_blk,
                                            int lane, const float4* llr,
                                            float4& na, float4& nb) {
  const int c = t / kChunk;
  const int k = t & (kChunk - 1);
  if (k == 0 && t > 0) {   // stage chunk c; fetch chunk c + 1
    sh.llr[c & 1][lane][0] = na;
    sh.llr[c & 1][lane][1] = nb;
    load_llr_chunk(llr, c + 1, n_blk, lane, na, nb);
    __syncwarp();
  }
  const float4 a = sh.llr[c & 1][k][0];
  const float4 b = sh.llr[c & 1][k][1];
  const float sum = ((((((a.x + a.y) + a.z) + a.w) + b.x) + b.y) + b.z) + b.w;
  const float d = sum * kScale;
  const float m0 = sh.pm[kCur][pm_at(lane)];
  const float m1 = sh.pm[kCur][pm_at(lane + 32)];
  sh.pm[kCur ^ 1][pm_at(lane)] = (m0 + d) + 1.0f;
  sh.pm[kCur ^ 1][pm_at(lane + 32)] = (m1 + d) + 1.0f;
  __syncwarp();
}

__global__ void __launch_bounds__(32)
vit_floor_kernel(const float* __restrict__ lp,   // [B, n_blk, 2k]
                 int32_t* __restrict__ out,      // [B, 64]
                 int n_blk) {
  __shared__ WarpShared sh;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const float4* llr =
      reinterpret_cast<const float4*>(lp + (size_t)b * n_blk * 2 * kK);

  sh.pm[0][pm_at(lane)] = 0.0f;
  sh.pm[0][pm_at(lane + 32)] = 0.0f;
  float4 na, nb;
  {
    float4 a, c;
    load_llr_chunk(llr, 0, n_blk, lane, a, c);
    sh.llr[0][lane][0] = a;
    sh.llr[0][lane][1] = c;
    load_llr_chunk(llr, 1, n_blk, lane, na, nb);
    __syncwarp();
  }
  for (int t = 0; t < n_blk; t += 2) {
    floor_block<0>(sh, t, n_blk, lane, llr, na, nb);
    if (t + 1 < n_blk) floor_block<1>(sh, t + 1, n_blk, lane, llr, na, nb);
  }
  const float* fin = sh.pm[n_blk & 1];
  int32_t* o = out + (size_t)b * kStates;
  o[lane] = (int32_t)fin[pm_at(lane)];
  o[lane + 32] = (int32_t)fin[pm_at(lane + 32)];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted). lp must be 16-byte aligned and batch > 0 (checked by the
// wrapper).
extern "C" int vit_floor_launch(const void* lp, void* out, int batch,
                                int n_blk, void* stream) {
  vit_floor_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<int32_t*>(out), n_blk);
  return static_cast<int>(cudaGetLastError());
}
