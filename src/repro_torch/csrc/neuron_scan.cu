// The ssm state neurons' recurrence over all T steps, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this recurrence as a loop of
// vectorised steps (`SimLayer._neuron_batch` in
// src/repro/neuromorphic/network.py), and so did the port, at about five
// kernel launches a step.  For each neuron n, from x = x0[n]:
//
//   x = decay * x + pre[t, n];   y[t, n] = force_active ? |x| + 1 : x
//
// in float32, each operation rounded on its own as the loop's separate
// PyTorch kernels round it (__fmul_rn and __fadd_rn, which nvcc never
// contracts into an FMA) and in the loop's order, so the result is the
// loop's bit for bit, NaN and inf included.  A chunked or tree scan would
// round differently.
//
// What bounds it on this card: bytes.  pre is read once and y written once,
// 8 bytes a neuron and step against two to four flops, and the only
// dependence runs along T within one neuron.  A (1,024 x 4,096) layer moves
// 33.6 MB: 10.0 us at 3.35 TB/s.  Its chain of 1,024 dependent multiplies
// and adds is about 8 cycles a step, about half of that.
//
// Design: one thread a neuron, one warp a block of 32 neighbouring neurons,
// so a 4,096-neuron layer is 128 blocks over the 132 SMs.  The loads of pre
// do not depend on the chain: each thread stages its own column of pre in
// kRows-step tiles in shared memory with 4-byte cp.async (the warp's 32
// copies of one row are one coalesced 128-byte read, so any row stride and
// a ragged last block need no alignment), kStages - 1 tiles ahead of the
// chain, about 28 KB a warp in flight against the memory's latency.  Each
// thread reads back only what it copied itself, so cp.async.wait_group
// alone orders a tile's copy before its use; a __syncwarp() before a slot
// is refilled orders the reads of its last use before the new copy.  The
// stores of y are the warp's coalesced 128-byte rows.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;     // neurons in a block, one a thread
constexpr int kRows = 32;     // steps in a staged tile
constexpr int kStages = 8;    // tiles in the ring: 32 KB of shared memory

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kForceActive>
__global__ void __launch_bounds__(kWarp)
ssm_scan_kernel(const float* __restrict__ pre, long long ld,
                const float* __restrict__ x0, float* __restrict__ y,
                float* __restrict__ x_out, int T, int N, float decay) {
  __shared__ float ring[kStages][kRows][kWarp];
  const int lane = threadIdx.x;
  const int n = blockIdx.x * kWarp + lane;
  const bool live = n < N;
  // a lane past the ragged edge copies its neighbour's column and stores
  // nothing, so every lane runs the same copies and waits
  const float* col = pre + (live ? n : N - 1);
  const int tiles = (T + kRows - 1) / kRows;

  // copy tile `tile` into its slot; one commit group a tile, empty past T
  auto fetch = [&](int tile) {
    if (tile < tiles) {
      const int t0 = tile * kRows;
      const int rows = min(kRows, T - t0);
      float* slot = &ring[tile % kStages][0][lane];
      for (int r = 0; r < rows; ++r)
        copy4(slot + r * kWarp, col + static_cast<long long>(t0 + r) * ld);
    }
    commit();
  };
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  float x = live ? x0[n] : 0.0f;
  for (int tile = 0; tile < tiles; ++tile) {
    __syncwarp();      // the slot refilled next was last read in tile - 1
    fetch(tile + kStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    const float* slot = &ring[tile % kStages][0][lane];
    const int t0 = tile * kRows;
    float* out = y + static_cast<long long>(t0) * N + n;
    auto step = [&](int r) {
      x = __fadd_rn(__fmul_rn(decay, x), slot[r * kWarp]);
      if (live)
        out[static_cast<long long>(r) * N] =
            kForceActive ? __fadd_rn(fabsf(x), 1.0f) : x;
    };
    if (T - t0 >= kRows) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) step(r);
    } else {
      for (int r = 0; r < T - t0; ++r) step(r);
    }
  }
  if (live) x_out[n] = x;
}

}  // namespace

// pre: (T, N) float32 with row stride `ld` elements and unit column
// stride; x0, x_out: (N,); y: (T, N) row-major.  `decay` is the float32
// the loop's scalar multiply uses.  Launches on `stream` (with T = 0 it
// copies x0 to x_out instead) and returns the launch's cudaError_t.
extern "C" int ssm_scan_launch(const float* pre, long long ld, const float* x0,
                               float* y, float* x_out, int T, int N,
                               float decay, int force_active, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (T <= 0)
    return static_cast<int>(cudaMemcpyAsync(x_out, x0, N * sizeof(float),
                                            cudaMemcpyDeviceToDevice, s));
  const dim3 grid((N + kWarp - 1) / kWarp);
  if (force_active)
    ssm_scan_kernel<true><<<grid, kWarp, 0, s>>>(pre, ld, x0, y, x_out, T, N,
                                                 decay);
  else
    ssm_scan_kernel<false><<<grid, kWarp, 0, s>>>(pre, ld, x0, y, x_out, T,
                                                  N, decay);
  return static_cast<int>(cudaGetLastError());
}
