// The neuron epilogue of one layer's time batch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this glue as separate NumPy
// expressions after each layer's synaptic forward (`SimLayer.step_batch` in
// src/repro/neuromorphic/network.py), and so did the port, as about ten
// eager PyTorch kernels over (T, n) maps.  For each step t and neuron n:
//
//   v = pre[t, n] (+ bias[n]);   v = neuron(v);   v = v (* gate[n])
//   y[t, n]      = v
//   msgs[t, n]   = v != 0        (a NaN is a message)
//   acts[t, n]   = macs[t, n] > 0
//   counts[t]    = sum over n of msgs[t, n], as float32 and as float64
//
// where neuron is the identity (a stateful neuron's messages, computed
// already), relu, or force-active relu |v| + 1.  Each operation rounds on
// its own as the eager kernel it replaces does (__fadd_rn, __fmul_rn, which
// nvcc never contracts into an FMA), and relu is PyTorch's clamp_min
// expression (`isnan(v) ? v : max(v, 0)`), so every map is the eager bits,
// NaN and signed zeros included.  The counts are integers below 2**24, so
// any order of summation gives the same bits.
//
// What bounds it on this card: bytes.  A relu layer reads pre and macs and
// writes y, msgs and acts, 20 bytes a neuron and step against a few flops;
// an identity layer without a gate does not write y (the caller keeps the
// input as the messages), 16 bytes.  The mamba2-1.3b head (1,024 x 50,277,
// force-active) moves 1.03 GB: 0.307 ms at 3.35 TB/s.
//
// Design: one block of 256 threads a row (a step) when the rows fill the
// card, so a row's count is one block reduction and one plain store; with
// few rows (the step-major engine's T = 1) a row is split over column
// chunks whose partial counts are added atomically into zeroed outputs.
// Each thread handles kUnroll columns an iteration, kThreads apart, with
// all their loads issued before any use.  A row's sweep starts at the
// 128-byte line that holds its first output, so each warp's three stores
// fill whole lines even where n is odd (the mamba2 head's 50,277: rows
// starting mid-line halved the kernel's speed there); the loads of pre,
// a row slice of a padded product, may straddle two lines instead, which
// the caches absorb.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kSpan = kThreads * kUnroll;   // columns a block iteration
constexpr int kIdentity = 0, kRelu = 1, kForceActive = 2;

template <int kCode>
__global__ void __launch_bounds__(kThreads)
neuron_epilogue_kernel(const float* __restrict__ pre, long long ld_pre,
                       const float* __restrict__ macs, long long ld_macs,
                       const float* __restrict__ bias,
                       const float* __restrict__ gate, float* __restrict__ y,
                       float* __restrict__ msgs, float* __restrict__ acts,
                       float* __restrict__ counts,
                       double* __restrict__ counts64, int N, int chunks,
                       int chunk_cols) {
  __shared__ int warp_sums[kThreads / 32];
  const int row = blockIdx.x / chunks;
  const int chunk = blockIdx.x - row * chunks;
  const int c0 = chunk * chunk_cols;
  const int c1 = min(N, c0 + chunk_cols);
  const float* p_row = pre + static_cast<long long>(row) * ld_pre;
  const float* m_row = macs + static_cast<long long>(row) * ld_macs;
  const long long out = static_cast<long long>(row) * N;
  int sent = 0;
  const int lead = static_cast<int>((out + c0) & 31);  // floats past a line
  for (int base = c0 - lead + threadIdx.x; base < c1; base += kSpan) {
    float v[kUnroll], m[kUnroll], b[kUnroll], g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * kThreads;
      const bool live = c >= c0 && c < c1;
      v[u] = live ? p_row[c] : 0.0f;
      m[u] = live ? m_row[c] : 0.0f;
      b[u] = (live && bias) ? bias[c] : 0.0f;
      g[u] = (live && gate) ? gate[c] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * kThreads;
      if (c < c0 || c >= c1) continue;
      float x = v[u];
      if (bias) x = __fadd_rn(x, b[u]);
      if (kCode == kRelu) x = isnan(x) ? x : fmaxf(x, 0.0f);
      if (kCode == kForceActive) x = __fadd_rn(fabsf(x), 1.0f);
      if (gate) x = __fmul_rn(x, g[u]);
      const bool msg = x != 0.0f;
      if (y) y[out + c] = x;
      msgs[out + c] = msg ? 1.0f : 0.0f;
      acts[out + c] = m[u] > 0.0f ? 1.0f : 0.0f;
      sent += msg;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sent += __shfl_xor_sync(0xffffffffu, sent, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sent;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    if (chunks == 1) {
      counts[row] = static_cast<float>(total);
      counts64[row] = static_cast<double>(total);
    } else if (total) {
      atomicAdd(counts + row, static_cast<float>(total));
      atomicAdd(counts64 + row, static_cast<double>(total));
    }
  }
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!cached[dev] &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return cached[dev];
}

}  // namespace

// pre: (T, N) float32 with row stride `ld_pre` and unit column stride;
// macs: (T, N) float32, row stride `ld_macs`; bias, gate: (N,) or null;
// y (null: not written; the identity without bias or gate), msgs, acts:
// (T, N) row-major (starting on a 128-byte line for whole-line stores;
// any alignment gives the same maps); counts: (T,) float32, counts64:
// (T,) float64.  `code` is 0 identity, 1 relu, 2 force-active relu.
// Launches on `stream` and returns the launch's cudaError_t
// (cudaErrorInvalidValue for a bad code).
extern "C" int neuron_epilogue_launch(const float* pre, long long ld_pre,
                                      const float* macs, long long ld_macs,
                                      const float* bias, const float* gate,
                                      float* y, float* msgs, float* acts,
                                      float* counts, double* counts64, int T,
                                      int N, int code, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (code < kIdentity || code > kForceActive)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0) {
    cudaError_t err = cudaMemsetAsync(counts, 0, T * sizeof(float), s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(counts64, 0, T * sizeof(double), s);
    return static_cast<int>(err);
  }
  // one block a row while the rows fill the card; else column chunks
  const int sms = sm_count();
  const int spans = (N + kSpan - 1) / kSpan;
  int chunks = 1;
  if (T < 2 * sms) chunks = min(spans, (4 * sms + T - 1) / T);
  const int chunk_cols = ((spans + chunks - 1) / chunks) * kSpan;
  chunks = (N + chunk_cols - 1) / chunk_cols;
  if (chunks > 1) {
    cudaError_t err = cudaMemsetAsync(counts, 0, T * sizeof(float), s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(counts64, 0, T * sizeof(double), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(T) * chunks);
  if (code == kRelu)
    neuron_epilogue_kernel<kRelu><<<grid, kThreads, 0, s>>>(
        pre, ld_pre, macs, ld_macs, bias, gate, y, msgs, acts, counts,
        counts64, N, chunks, chunk_cols);
  else if (code == kForceActive)
    neuron_epilogue_kernel<kForceActive><<<grid, kThreads, 0, s>>>(
        pre, ld_pre, macs, ld_macs, bias, gate, y, msgs, acts, counts,
        counts64, N, chunks, chunk_cols);
  else
    neuron_epilogue_kernel<kIdentity><<<grid, kThreads, 0, s>>>(
        pre, ld_pre, macs, ld_macs, bias, gate, y, msgs, acts, counts,
        counts64, N, chunks, chunk_cols);
  return static_cast<int>(cudaGetLastError());
}
