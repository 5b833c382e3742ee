// Block-sparse event-driven matmuls for Hopper (sm_90a): one tile body,
// two TPU kernels.
//
// Replaces `_event_matmul_kernel` / `event_matmul_pallas` (the 1-D kernel)
// and `_event_matmul2_kernel` / `event_matmul2_pallas` (the joint kernel)
// in src/repro/kernels/event_matmul/kernel.py.  Same contract: y = x @ w
// over 128 x 128 x 128 tiles, where the (m, n) output tile sums only the
// k-tiles in its live list and every skipped tile product is an exact
// zero; a tile whose list is empty writes zeros.  The two differ only in
// where the list lives:
//   1-D   (kPerPair = false): idx[m, :cnt[m]], the activation tiles of
//         m-block m that hold an event, shared by every n;
//   joint (kPerPair = true):  idx[m, n, :cnt[m, n]], the k steps whose
//         activation tile has an event AND whose weight tile a nonzero.
// Operands are float32 or bfloat16 (one type for x, w and the output; the
// joint entry point takes float32 only).  Products accumulate in float32
// with one FMA each (a bf16 x bf16 product is exact in float32) and the sum
// is rounded to the operand type once, at the end.
//
// What bounds it on this card: operations.  Every live tile product is
// 2 * 128^3 flops against 2 * 64 KiB (float32) of operands, and the
// products run in plain fp32 FMA (no TF32, no tensor cores), whose peak is
// ~67 TFLOP/s -- so the compute roof sits far below the 3.35 TB/s memory
// roof.  fp32 FMA is required for the float32 value matmul, which must stay
// within rtol 1e-6 of a float32 reference (TF32 would not).  The counter
// matmul multiplies 0/1 masks: fp32 keeps its integer sums exact below
// 2^24, but so would int8 tensor-core products with int32 sums, at a far
// higher rate; bf16 operands would allow the 989 TFLOP/s tensor cores.
// This first version uses neither.
//
// Design: one 256-thread block per (m, n) output tile (Hopper has no
// scalar prefetch, so the block reads its own cnt and k list).  The k loop
// runs only over the live list, so dead tiles are never loaded.  Each live
// k-tile is staged through shared memory 8 k-rows at a time, double
// buffered: while the block multiplies one stage, every thread holds its
// share of the next stage (4 consecutive elements of one x row and of one
// w row: a float4, or 8 bytes of bf16, converted to float32) in registers
// and stores it to the other buffer afterwards, so one barrier per stage
// suffices.  x is stored transposed (xs[k][row]) so both operands are read
// as float4s.  Each thread owns an 8 x 8 register block of the output
// (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, likewise columns), read
// conflict-free, and accumulates with one FMA per product in ascending k
// order -- the same order in both instances, so with an all-ones weight
// occupancy the joint and the 1-D product give the same bits.  Operands
// arrive padded to tile multiples and 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;              // bm = bk = bn
constexpr int kStep = 8;                // k rows per shared-memory stage
constexpr int kStages = kTile / kStep;  // stages per live k-tile
constexpr int kThreads = 256;           // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T, bool kPerPair>
__global__ void __launch_bounds__(kThreads)
event_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ idx, const int* __restrict__ cnt,
                    T* __restrict__ out, int nb, int kb, int K, int N) {
  const int n = blockIdx.x;
  const int m = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  __shared__ __align__(16) float xs[2][kStep][kTile];   // xs[.][k][row]
  __shared__ __align__(16) float ws[2][kStep][kTile];   // ws[.][k][col]

  const int slot = kPerPair ? m * nb + n : m;   // whose k list
  const int total = cnt[slot] * kStages;
  const int* list = idx + static_cast<size_t>(slot) * kb;

  // this thread's share of a stage: 4 consecutive k of one x row, and
  // 4 consecutive columns of one w row
  const int xr = tid / 2, xc = (tid % 2) * 4;
  const int wr = tid / 32, wc = (tid % 32) * 4;
  const T* xrow = x + (static_cast<size_t>(m) * kTile + xr) * K + xc;
  const T* wrow = w + static_cast<size_t>(wr) * N
                + static_cast<size_t>(n) * kTile + wc;

  float4 xv, wv;
  auto fetch = [&](int q) {
    const int k = list[q / kStages] * kTile + (q % kStages) * kStep;
    xv = load4(xrow + k);
    wv = load4(wrow + static_cast<size_t>(k) * N);
  };
  auto stash = [&](int buf) {
    xs[buf][xc + 0][xr] = xv.x;
    xs[buf][xc + 1][xr] = xv.y;
    xs[buf][xc + 2][xr] = xv.z;
    xs[buf][xc + 3][xr] = xv.w;
    *reinterpret_cast<float4*>(&ws[buf][wr][wc]) = wv;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (total > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int q = 0; q < total; ++q) {
    const int buf = q & 1;
    if (q + 1 < total) fetch(q + 1);
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (q + 1 < total) stash(buf ^ 1);
    __syncthreads();
  }

  T* oblk = out + static_cast<size_t>(m) * kTile * N
          + static_cast<size_t>(n) * kTile;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : 64) + ty * 4 + (i % 4);
    T* o = oblk + static_cast<size_t>(row) * N;
    store4(o + tx * 4, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    store4(o + 64 + tx * 4, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

template <typename T, bool kPerPair>
int launch(const T* x, const T* w, const int* idx, const int* cnt, T* out,
           int mb, int nb, int kb, int K, int N, void* stream) {
  if (mb <= 0 || nb <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid(nb, mb);
  event_matmul_kernel<T, kPerPair>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          x, w, idx, cnt, out, nb, kb, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The 1-D product.  x (mb*128, K), w (K, N), out (mb*128, N): row-major,
// float32 (bf16 == 0) or bfloat16 (bf16 == 1), 16-byte aligned, K and N
// multiples of 128.  idx (mb, kb) and cnt (mb,): int32.  Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int event_matmul_launch(const void* x, const void* w,
                                   const int* idx, const int* cnt, void* out,
                                   int mb, int nb, int kb, int K, int N,
                                   int bf16, void* stream) {
  using bf = __nv_bfloat16;
  if (bf16)
    return launch<bf, false>(static_cast<const bf*>(x),
                             static_cast<const bf*>(w), idx, cnt,
                             static_cast<bf*>(out), mb, nb, kb, K, N, stream);
  return launch<float, false>(static_cast<const float*>(x),
                              static_cast<const float*>(w), idx, cnt,
                              static_cast<float*>(out), mb, nb, kb, K, N,
                              stream);
}

// The joint product.  x (mb*128, K), w (K, N), out (mb*128, N): row-major
// float32, 16-byte aligned, K and N multiples of 128.  idx (mb, nb, kb) and
// cnt (mb, nb): int32.  Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int event_matmul2_launch(const float* x, const float* w,
                                    const int* idx, const int* cnt,
                                    float* out, int mb, int nb, int kb,
                                    int K, int N, void* stream) {
  return launch<float, true>(x, w, idx, cnt, out, mb, nb, kb, K, N, stream);
}
