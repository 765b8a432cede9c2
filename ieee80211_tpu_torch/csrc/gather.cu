// Window slice of float32 I/Q, in three modes. CUDA C++ for sm_90a.
//   per-row:       out[b, i]    = x[b, s_b + i],    x [B, N]
//   shared-source: out[g, i]    = x[s_g + i],       x [N] (one capture, G starts)
//   multi-chain:   out[g, r, i] = x[r, s_g + i],    x [R, N] (R chains, G starts)
// with s = clip(start, 0, N - L) in all three, start int32 or int64.
//
// Replaces the TPU kernel ieee80211_tpu/ops/pallas/gather.py (_kernel :37,
// _build_call :77, wrapper batch_slice_iq_pallas :95). That kernel streamed
// whole rows and rotated them in registers only because Mosaic's DMAs must
// be (8, 128)-aligned; a copy at any offset needs none of that here. The
// shared-source mode serves ieee80211_tpu/rx/receiver.py::capture_windows
// (:354), which the JAX package runs as a vmapped dynamic_slice: every SIG
// and DATA window of the streaming receiver comes from one device-resident
// capture. The multi-chain mode serves capture_windows_mimo (:368), the
// dual-chain receiver's windows: one launch cuts the same window out of
// every chain, so no per-chain launches and no stack of their outputs.
//
// What bounds it on the H100: device-memory bytes, each covered input
// sample read once and each output sample written once (8 bytes each): 34 MB
// for the 1024 x 2080-sample windows of the main path, about 10 us at
// 3.35 TB/s. A launch's few microseconds of fixed cost sit beside that at
// the small shapes.
// What the design does about it:
//   * each output row (one window of one chain) is one thread block, the
//     window in gridDim.x (so windows are not limited to 65535) and the
//     chain in gridDim.z; when there are fewer rows than SMs, each row is
//     split into column blocks of at least kThreads pairs;
//   * each thread moves two samples at a time with one 16-byte store, up to
//     kUnroll loads in flight before its stores, and no more than 32
//     registers, so that 8 blocks of 256 threads fit on an SM;
//   * a row's output starts 16-byte aligned when its first sample is even:
//     when it is odd (odd L, odd row) its first sample is copied alone, and
//     an odd sample left at the end too;
//   * the source of a row is read as 16-byte loads when its first pair is
//     16-byte aligned (an even clipped start in an aligned tensor), as two
//     8-byte loads per pair otherwise: the same contiguous bytes per warp;
//   * the clipped start is read once per thread from a broadcast load; the
//     modes differ only in the source strides per window (N or 0) and per
//     chain (N, with R = 1 in the other two modes).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 2048 threads: the SM's most
constexpr int kUnroll = 4;
constexpr int kSms = 132;

// pair k (samples 2k, 2k + 1) of p
template <bool kAligned>
__device__ __forceinline__ float4 load_pair(const float2* __restrict__ p,
                                            int k) {
  if (kAligned) return __ldg(reinterpret_cast<const float4*>(p) + k);
  const float2 a = __ldg(p + 2 * k);
  const float2 b = __ldg(p + 2 * k + 1);
  return make_float4(a.x, a.y, b.x, b.y);
}

// pairs lo..hi-1 of src to dst, up to kUnroll loads in flight per thread
template <bool kAligned>
__device__ __forceinline__ void copy_pairs(const float2* __restrict__ src,
                                           float4* __restrict__ dst, int lo,
                                           int hi) {
  for (int k = lo + threadIdx.x; k < hi; k += kUnroll * kThreads) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k + u * kThreads < hi)
        v[u] = load_pair<kAligned>(src, k + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k + u * kThreads < hi) dst[k + u * kThreads] = v[u];
  }
}

template <typename Start>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
slice_iq_kernel(const float2* __restrict__ x,      // [B, N], [N] or [R, N]
                const Start* __restrict__ start,   // [B]
                float2* __restrict__ out,          // [B, R, L]
                int n, int len, long long row_stride, int span) {
  const int g = blockIdx.x;   // window
  const int r = blockIdx.z;   // chain
  const long long s = min(max((long long)__ldg(start + g), 0LL),
                          (long long)(n - len));
  const float2* src = x + g * row_stride + (long long)r * n + s;
  float2* dst = out + ((long long)g * gridDim.z + r) * len;
  // the first sample alone when the row's output starts at 8 mod 16 bytes
  const int head = (int)((reinterpret_cast<uintptr_t>(dst) >> 3) & 1);
  const int pairs = (len - head) >> 1;
  const int lo = blockIdx.y * span;
  const int hi = min(lo + span, pairs);
  float4* d = reinterpret_cast<float4*>(dst + head);
  if ((reinterpret_cast<uintptr_t>(src + head) & 15) == 0)
    copy_pairs<true>(src + head, d, lo, hi);
  else
    copy_pairs<false>(src + head, d, lo, hi);
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    if (head) dst[0] = __ldg(src);
    if ((len - head) & 1) dst[len - 1] = __ldg(src + len - 1);
  }
}

template <typename Start>
cudaError_t launch(const void* x, const void* start, void* out, int windows,
                   int chains, int n, int len, long long row_stride,
                   cudaStream_t stream) {
  const int rows = windows * chains;
  const int pairs = len >> 1;
  // column blocks per row: a row per block once there are as many rows as
  // SMs; fewer rows are split, with no block of fewer pairs than threads
  const int fill = (kSms + rows - 1) / rows;
  const int splits =
      std::max(1, std::min(fill, (pairs + kThreads - 1) / kThreads));
  const int span = (pairs + splits - 1) / splits;
  slice_iq_kernel<Start>
      <<<dim3(windows, splits, chains), kThreads, 0, stream>>>(
          static_cast<const float2*>(x), static_cast<const Start*>(start),
          static_cast<float2*>(out), n, len, row_stride, span);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted). x is [windows, n] (per_row != 0) or [chains, n] (per_row == 0:
// shared-source with chains = 1, multi-chain), float2, 8-byte aligned;
// start is [windows] int64 (start64 != 0) or int32; out is [windows, chains,
// len], 8-byte aligned. Requires 0 < len <= n, 0 < windows,
// windows * chains < 2^31 and 0 < chains <= 65535 (checked by the
// wrappers).
extern "C" int slice_iq_launch(const void* x, const void* start, int start64,
                               void* out, int windows, int chains, int n,
                               int len, int per_row, void* stream) {
  const long long row_stride = per_row ? (long long)n : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      start64 ? launch<long long>(x, start, out, windows, chains, n, len,
                                  row_stride, st)
              : launch<int>(x, start, out, windows, chains, n, len,
                            row_stride, st));
}
