// Window slice of float32 I/Q, in two modes. CUDA C++ for sm_90a.
//   per-row:       out[b, i] = x[b, s_b + i], x [B, N]
//   shared-source: out[g, i] = x[s_g + i],    x [N] (one capture, G starts)
// with s = clip(start, 0, N - L) in both.
//
// Replaces the TPU kernel ieee80211_tpu/ops/pallas/gather.py (_kernel :37,
// _build_call :77, wrapper batch_slice_iq_pallas :95). That kernel streamed
// whole rows and rotated them in registers only because Mosaic's DMAs must
// be (8, 128)-aligned; a copy at any offset needs none of that here. The
// shared-source mode serves ieee80211_tpu/rx/receiver.py::capture_windows
// (:354), which the JAX package runs as a vmapped dynamic_slice: every SIG
// and DATA window of the streaming receiver comes from one device-resident
// capture.
//
// What bounds it on the H100: device-memory bytes, 8 read and 8 written per
// sample: 34 MB for the 1024 x 2080-sample window of the main path, about
// 10 us at 3.35 TB/s.
// What this simple design does about it: one thread per sample (one float2),
// neighbouring threads on neighbouring samples, so each warp reads and
// writes 256 contiguous bytes; grid (ceil(L / 256), B), with each row's
// start read once per thread from a broadcast load and clamped in place.
// The two modes differ only in the source row stride (N or 0).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
slice_iq_kernel(const float2* __restrict__ x,        // [B, N] or [N]
                const int32_t* __restrict__ start,   // [B]
                float2* __restrict__ out,            // [B, L]
                int n, int len, size_t row_stride) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= len) return;
  const int s = min(max(__ldg(start + b), 0), n - len);
  out[(size_t)b * len + i] = __ldg(x + b * row_stride + s + i);
}

cudaError_t launch(const void* x, const void* start, void* out, int batch,
                   int n, int len, size_t row_stride, void* stream) {
  const dim3 grid((len + kThreads - 1) / kThreads, batch);
  slice_iq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const int32_t*>(start),
      static_cast<float2*>(out), n, len, row_stride);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 when the launch was
// accepted). Both require 0 < len <= n and batch <= 65535 (checked by the
// wrappers).
extern "C" int slice_iq_launch(const void* x, const void* start, void* out,
                               int batch, int n, int len, void* stream) {
  return static_cast<int>(launch(x, start, out, batch, n, len, (size_t)n,
                                 stream));
}

extern "C" int slice_iq_shared_launch(const void* x, const void* start,
                                      void* out, int batch, int n, int len,
                                      void* stream) {
  return static_cast<int>(launch(x, start, out, batch, n, len, 0, stream));
}
