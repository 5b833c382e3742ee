// Within-window cumulative sum along time for Hopper (sm_90a).
//
// Replaces the TPU kernel `_window_cumsum_kernel` / `window_cumsum_pallas`
// in src/repro/kernels/sigma_delta/kernel.py: for a (T, D) delta stream cut
// into T / window windows, out[t] = sum of x over the window's rows up to
// and including t; a window whose live flag is 0 writes zeros without
// reading its input.
//
// What bounds it on this card: bytes.  One add per element against 8 bytes
// moved (read once, written once), far below the card's ~20 flops/byte
// fp32 balance point.
//
// Design: one thread per (window, column), walking the window's rows in
// order, so each warp's loads and stores are 32 consecutive floats of one
// row (coalesced along D) and the sum keeps np.cumsum's sequential addition
// order.  The TPU kernel's lower-triangular-ones matmul existed only
// because an in-kernel cumsum lowers badly there; the card has no such
// need.  Quiet windows are decided per block (the flag is per window) and
// only store.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_cumsum_kernel(const float* __restrict__ x, const int* __restrict__ live,
                     float* __restrict__ out, int D, int window) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int win = blockIdx.y;
  if (d >= D) return;
  const size_t base = static_cast<size_t>(win) * window * D + d;
  if (live[win] == 0) {
    for (int t = 0; t < window; ++t)
      out[base + static_cast<size_t>(t) * D] = 0.0f;
    return;
  }
  float s = 0.0f;
#pragma unroll 8
  for (int t = 0; t < window; ++t) {
    s += x[base + static_cast<size_t>(t) * D];
    out[base + static_cast<size_t>(t) * D] = s;
  }
}

}  // namespace

// x, out: (n_windows * window, D) row-major float32; live: (n_windows,)
// int32.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int window_cumsum_launch(const float* x, const int* live,
                                    float* out, int n_windows, int D,
                                    int window, void* stream) {
  if (n_windows <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid((D + kThreads - 1) / kThreads, n_windows);
  window_cumsum_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, live, out, D, window);
  return static_cast<int>(cudaGetLastError());
}
