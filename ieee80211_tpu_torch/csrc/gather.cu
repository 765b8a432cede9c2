// Per-row window slice of float32 I/Q: out[b, i] = x[b, s_b + i] with
// s_b = clip(start[b], 0, N - L). CUDA C++ for sm_90a.
//
// Replaces the TPU kernel ieee80211_tpu/ops/pallas/gather.py (_kernel :37,
// _build_call :77, wrapper batch_slice_iq_pallas :95). That kernel streamed
// whole rows and rotated them in registers only because Mosaic's DMAs must
// be (8, 128)-aligned; a copy at any offset needs none of that here.
//
// What bounds it on the H100: device-memory bytes, 8 read and 8 written per
// sample: 34 MB for the 1024 x 2080-sample window of the main path, about
// 10 us at 3.35 TB/s.
// What this simple design does about it: one thread per sample (one float2),
// neighbouring threads on neighbouring samples, so each warp reads and
// writes 256 contiguous bytes; grid (ceil(L / 256), B), with each row's
// start read once per thread from a broadcast load and clamped in place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
slice_iq_kernel(const float2* __restrict__ x,        // [B, N]
                const int32_t* __restrict__ start,   // [B]
                float2* __restrict__ out,            // [B, L]
                int n, int len) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= len) return;
  const int s = min(max(__ldg(start + b), 0), n - len);
  out[(size_t)b * len + i] = __ldg(x + (size_t)b * n + s + i);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted). Requires 0 < len <= n and batch <= 65535 (checked by the
// wrapper).
extern "C" int slice_iq_launch(const void* x, const void* start, void* out,
                               int batch, int n, int len, void* stream) {
  const dim3 grid((len + kThreads - 1) / kThreads, batch);
  slice_iq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const int32_t*>(start),
      static_cast<float2*>(out), n, len);
  return static_cast<int>(cudaGetLastError());
}
