// Floor probe of the radix-4 Viterbi kernel (csrc/viterbi.cu). CUDA C++ for
// sm_90a.
//
// Replaces the TPU probe perf_vit_floor.py::main (kernel :14, pallas_call
// :37): the Viterbi kernel's skeleton with its add-compare-select replaced
// by one add, so that the difference between the two kernels' times on the
// same input is what the ACS costs on this card. Like the TPU probe it
// stores no survivors and does no traceback.
//
// The skeleton is viterbi.cu's: the same grid (64 state threads x 4 packets
// per 256-thread block), the same reads of the 2k = 8 depunctured LLRs per
// packet per block from [B, n_blk, 8] float32 (each state thread loads all
// eight through the read-only path), the same double-buffered path metrics
// in shared memory with one barrier per block. Per block each state does
//   m = (m + sum(llr of this block) * 1e-30f) + 1.0f
// in that order (perf_vit_floor.py:30; built with -fmad=false), so every
// output entry is n_blk. Output int32 [B, 64], packet-major as viterbi.cu.
//
// What bounds it on the H100: the per-block latency of a load, a few adds,
// a shared-memory store and a barrier, times n_blk; the LLR bytes (32 per
// packet per block, 38 MB at 1024 x 1176 blocks) are small beside it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 4;          // trellis steps per block, as viterbi.cu
constexpr int kStates = 64;
constexpr int kPackets = 4;    // packets per thread block, as viterbi.cu

__global__ void __launch_bounds__(kStates * kPackets)
vit_floor_kernel(const float* __restrict__ lp,   // [B, n_blk, 2k]
                 int32_t* __restrict__ out,      // [B, 64]
                 int batch, int n_blk) {
  __shared__ float pm[2][kPackets][kStates];
  const int s = threadIdx.x;
  const int w = threadIdx.y;
  const int b = blockIdx.x * kPackets + w;
  const bool live = b < batch;   // rows past the batch still join barriers
  const size_t row = live ? (size_t)b : 0;
  const float* llr = lp + row * n_blk * 2 * kK;

  pm[0][w][s] = 0.0f;
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < n_blk; ++t) {
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 2 * kK; ++i)
      sum = sum + (live ? __ldg(llr + (size_t)t * 2 * kK + i) : 0.0f);
    const int nxt = cur ^ 1;
    pm[nxt][w][s] = (pm[cur][w][s] + sum * 1e-30f) + 1.0f;
    __syncthreads();
    cur = nxt;
  }
  if (live) out[(size_t)b * kStates + s] = (int32_t)pm[cur][w][s];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int vit_floor_launch(const void* lp, void* out, int batch,
                                int n_blk, void* stream) {
  const dim3 block(kStates, kPackets);
  const dim3 grid((batch + kPackets - 1) / kPackets);
  vit_floor_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<int32_t*>(out), batch,
      n_blk);
  return static_cast<int>(cudaGetLastError());
}
