// Window slice of float32 I/Q, in three modes. CUDA C++ for sm_90a.
//   per-row:       out[b, i]    = x[b, s_b + i],    x [B, N]
//   shared-source: out[g, i]    = x[s_g + i],       x [N] (one capture, G starts)
//   multi-chain:   out[g, r, i] = x[r, s_g + i],    x [R, N] (R chains, G starts)
// with s = clip(start, 0, N - L) in all three.
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
// What bounds it on the H100: device-memory bytes, 8 read and 8 written per
// sample: 34 MB for the 1024 x 2080-sample window of the main path, about
// 10 us at 3.35 TB/s.
// What this simple design does about it: one thread per sample (one float2),
// neighbouring threads on neighbouring samples, so each warp reads and
// writes 256 contiguous bytes; grid (ceil(L / 256), B, R), with each row's
// start read once per thread from a broadcast load and clamped in place.
// The modes differ only in the source strides: per window (N or 0) and per
// chain (N, or 0 with R = 1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
slice_iq_kernel(const float2* __restrict__ x,        // [B, N], [N] or [R, N]
                const int32_t* __restrict__ start,   // [B]
                float2* __restrict__ out,            // [B, R, L]
                int n, int len, size_t row_stride, size_t chain_stride) {
  const int b = blockIdx.y;
  const int r = blockIdx.z;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= len) return;
  const int s = min(max(__ldg(start + b), 0), n - len);
  out[((size_t)b * gridDim.z + r) * len + i] =
      __ldg(x + b * row_stride + r * chain_stride + s + i);
}

cudaError_t launch(const void* x, const void* start, void* out, int batch,
                   int chains, int n, int len, size_t row_stride,
                   size_t chain_stride, void* stream) {
  const dim3 grid((len + kThreads - 1) / kThreads, batch, chains);
  slice_iq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const int32_t*>(start),
      static_cast<float2*>(out), n, len, row_stride, chain_stride);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 when the launch was
// accepted). All require 0 < len <= n and batch, chains <= 65535 (checked by
// the wrappers).
extern "C" int slice_iq_launch(const void* x, const void* start, void* out,
                               int batch, int n, int len, void* stream) {
  return static_cast<int>(launch(x, start, out, batch, 1, n, len, (size_t)n,
                                 0, stream));
}

extern "C" int slice_iq_shared_launch(const void* x, const void* start,
                                      void* out, int batch, int n, int len,
                                      void* stream) {
  return static_cast<int>(launch(x, start, out, batch, 1, n, len, 0, 0,
                                 stream));
}

extern "C" int slice_iq_multi_launch(const void* x, const void* start,
                                     void* out, int batch, int chains, int n,
                                     int len, void* stream) {
  return static_cast<int>(launch(x, start, out, batch, chains, n, len, 0,
                                 (size_t)n, stream));
}
