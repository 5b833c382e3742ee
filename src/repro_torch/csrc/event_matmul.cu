// Block-sparse event-driven matmuls for Hopper (sm_90a): one tile body,
// two TPU kernels, three operand kinds.
//
// Replaces `_event_matmul_kernel` / `event_matmul_pallas` (the 1-D kernel)
// and `_event_matmul2_kernel` / `event_matmul2_pallas` (the joint kernel)
// in src/repro/kernels/event_matmul/kernel.py.  Same contract: y = x @ w
// over 128 x 128 x 128 tiles, where the (m, n) output tile sums only the
// k-tiles in its live list and every skipped tile product is an exact
// zero; a tile whose list is empty writes zeros.  The two differ only in
// how the list is built:
//   1-D   (kPerPair = false): the k tiles of m-block m that hold an event,
//         shared by every n;
//   joint (kPerPair = true):  the k tiles whose activation tile has an
//         event AND whose weight tile (k, n) a nonzero.
//
// Operand kinds (one instance each; x and w of one type):
//   F32  -- float32 values, 3xTF32 on the TF32 tensor cores: each operand
//           is split as hi = tf32_rna(v), lo = tf32_rna(v - hi), and each
//           k step of 8 accumulates a_lo*b_hi + a_hi*b_lo, then a_hi*b_hi.
//           The tensor core sums one stage (32 k) from zero; the stage's
//           sum joins the float32 accumulator through a rounded add.  Kept
//           in the tensor core across the whole list, the sum truncates at
//           every step, drifts one way, and missed float32 by 2.8e-5 at
//           K = 1024 (limit 1e-5); a stage's partial has a random sign, so
//           its truncations do not add up.  About float32 accuracy (the
//           dropped a_lo*b_lo term is ~2^-22 relative); float32 out.
//   BF16 -- bfloat16 operands, float32 accumulation, rounded once at the
//           store; bfloat16 out.
//   I8   -- int8 0/1 masks (the counter products), int32 accumulation,
//           converted to float32 at the store: exact while a sum stays
//           below 2^24.
//
// What bounds it on this card: operations for F32 (3 products per MAC at
// the 495 TFLOP/s TF32 rate) and BF16 at full tile liveness; bytes for I8
// (the float32 output outweighs its int8 operands) and for sparse BF16.
// The design answers each limit of the first version (SIMT fp32 FMA,
// synchronous staging, one block per 128 x 128 tile, host-built lists):
//
// * Tensor cores through mma.sync (m16n8k8 tf32, m16n8k16 bf16, m16n8k32
//   s8), not wgmma: a first tensor-core design.  With both operands
//   K-major (x as (M, K), w transposed to (N, K) by the wrapper) the three
//   kinds read their fragments at the same 32-bit word positions, so one
//   body serves all three: a k step is 8 words (k8 tf32, k16 bf16, k32 s8).
// * A ring of kStages = 4 shared-memory stages filled by 16-byte
//   cp.async: a stage is 128 bytes of k for the block's 64 x rows and 128
//   w rows (24 KB), 16-byte chunks XOR-swizzled by row so that fragment
//   reads are conflict-free.  The copies for stage q+3 are in flight while
//   stage q is multiplied; one barrier per stage.  96 KB of dynamic shared
//   memory per block, two blocks per SM.
// * 64-row output tiles (the activity granularity stays 128: a tile reads
//   the list of its 128-row block), four warps of 32 x 64 outputs each.
//   Where the output tiles alone would leave the card under one wave, the
//   wrapper asks for `splits` blocks per tile: block s takes live entries
//   [s*cnt/splits, (s+1)*cnt/splits) of the list and writes a float32
//   partial; a second pass sums the partials in split order.  No atomics
//   and a fixed k order: repeated launches give the same bits.
// * The block builds its own live list (the Hopper form of the TPU's
//   scalar prefetch): warp 0 reads the (Mb, Kb) activity bytes and, for
//   the joint kernel, the (Kb, Nb) occupancy bytes, and compacts the live
//   k steps in ascending order into shared memory with a ballot and a
//   popcount prefix, 32 k tiles per step.
//
// The bind (event_bind) runs first, in the same library call as the
// products it feeds: one pass over a layer's value operand and wire-event
// mask that writes both activity maps and the int8 counter operand, and a
// zero-padded copy of an operand only where a product would read past it
// (K not a multiple of 128, M not of 64, or x not packed and 16-byte
// aligned); every other operand is read in place.  Rows past M are never
// read: their 64-row blocks find an empty list.  It replaces the dozen
// PyTorch ops a layer took to pad, map and cast on the host's side.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kTile = 128;     // activity block, k tile and n tile
constexpr int kRows = 64;      // output rows per block
constexpr int kThreads = 128;  // four warps, 2 x 2, 32 x 64 outputs each
constexpr int kNT = 8;         // 8-column slices per warp
constexpr int kWords = 32;     // 32-bit words of k per staged row (128 B)
constexpr int kStages = 4;     // depth of the shared-memory ring
constexpr int kStageWords = (kRows + kTile) * kWords;
constexpr int kStageBytes = kStageWords * 4;
constexpr int kChunks = (kRows + kTile) * 8 / kThreads;  // 16 B copies

// kPromote: each stage's sum starts at zero in the tensor core and joins
// the accumulator through a rounded float32 add.  For the bind: Raw is the
// operand's bits, magnitude(v) its |v| as PyTorch's abs gives it (int8
// wraps: |-128| = -128), compared(t) the threshold as PyTorch compares a
// tensor of the kind with a float (in bfloat16 for bfloat16).
struct F32 {
  using T = float;
  using Acc = float;
  using Out = float;
  using Raw = uint32_t;
  static constexpr bool kPromote = true;
  static __device__ float magnitude(Raw v) { return fabsf(__uint_as_float(v)); }
  static __device__ float compared(float t) { return t; }
};
struct BF16 {
  using T = __nv_bfloat16;
  using Acc = float;
  using Out = __nv_bfloat16;
  using Raw = uint16_t;
  static constexpr bool kPromote = false;
  static __device__ float magnitude(Raw v) {
    return fabsf(__uint_as_float(static_cast<uint32_t>(v) << 16));
  }
  static __device__ float compared(float t) {
    return __bfloat162float(__float2bfloat16_rn(t));
  }
};
struct I8 {
  using T = int8_t;
  using Acc = int;
  using Out = float;
  using Raw = int8_t;
  static constexpr bool kPromote = false;
  static __device__ float magnitude(Raw v) {
    return static_cast<float>(static_cast<int8_t>(v < 0 ? -v : v));
  }
  static __device__ float compared(float t) { return t; }
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k step (8 words) of a warp's 32 x 64 tile: a[i] holds the A
// fragments of its two 16-row slices, b[j] the B fragments of its eight
// 8-column slices, as raw words of the operand type.
__device__ __forceinline__ void warp_step(float (&acc)[2][kNT][4],
                                          const uint32_t (&a)[2][4],
                                          const uint32_t (&b)[kNT][2], F32) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32(a[i][r], ah[i][r], al[i][r]);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    uint32_t bh[2], bl[2];
    split_tf32(b[j][0], bh[0], bl[0]);
    split_tf32(b[j][1], bh[1], bl[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mma_tf32(acc[i][j], al[i], bh);
      mma_tf32(acc[i][j], ah[i], bl);
      mma_tf32(acc[i][j], ah[i], bh);
    }
  }
}

__device__ __forceinline__ void warp_step(float (&acc)[2][kNT][4],
                                          const uint32_t (&a)[2][4],
                                          const uint32_t (&b)[kNT][2], BF16) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
}

__device__ __forceinline__ void warp_step(int (&acc)[2][kNT][4],
                                          const uint32_t (&a)[2][4],
                                          const uint32_t (&b)[kNT][2], I8) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a[i], b[j]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(float* p, int a, int b) {
  store2(p, static_cast<float>(a), static_cast<float>(b));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Grid (nb, mp / 64, splits), 128 threads.  x (mp, K) and wt (nb*128, K)
// row-major, K = kb * 128; act (mp / 128, kb) and occ (kb, nb) bytes;
// out (mp, nb*128), or with splits > 1 the partials part (splits, mp,
// nb*128) float32.  Rows at or past m_rows are padding: their tiles skip.
template <class Kind, bool kPerPair>
__global__ void __launch_bounds__(kThreads, 2)
event_matmul_kernel(const typename Kind::T* __restrict__ x,
                    const typename Kind::T* __restrict__ wt,
                    const unsigned char* __restrict__ act,
                    const unsigned char* __restrict__ occ,
                    typename Kind::Out* __restrict__ out,
                    float* __restrict__ part, int m_rows, int nb, int kb) {
  using T = typename Kind::T;
  using Acc = typename Kind::Acc;
  constexpr int kSub = static_cast<int>(sizeof(T));  // stages per k tile

  extern __shared__ __align__(1024) uint32_t smem[];
  int* list = reinterpret_cast<int*>(smem + kStages * kStageWords);

  const int n = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the live list, ascending: a ballot over 32 k tiles at a time
  if (warp == 0) {
    int count = 0;
    if (row0 < m_rows) {
      const unsigned char* arow = act + static_cast<size_t>(row0 / kTile) * kb;
      for (int base = 0; base < kb; base += 32) {
        const int k = base + lane;
        bool live = k < kb && arow[k] != 0;
        if (kPerPair) live = live && occ[static_cast<size_t>(k) * nb + n] != 0;
        const unsigned bits = __ballot_sync(0xffffffffu, live);
        if (live) list[count + __popc(bits & ((1u << lane) - 1u))] = k;
        count += __popc(bits);
      }
    }
    if (lane == 0) list[kb] = count;
  }
  __syncthreads();
  const int cnt = list[kb];
  const int lo = static_cast<int>(static_cast<long long>(split) * cnt / splits);
  const int hi =
      static_cast<int>(static_cast<long long>(split + 1) * cnt / splits);
  const int total = (hi - lo) * kSub;

  // stage q: 128 bytes of k (sub-step q % kSub of live tile lo + q / kSub)
  // for the 64 x rows (stage rows 0..63) and 128 w rows (64..191); chunk c
  // of stage row r lands at chunk c ^ (r % 8) of that row
  const size_t row_bytes = static_cast<size_t>(kb) * kTile * sizeof(T);
  const char* xbase =
      reinterpret_cast<const char*>(x) + static_cast<size_t>(row0) * row_bytes;
  const char* wbase = reinterpret_cast<const char*>(wt) +
                      static_cast<size_t>(n) * kTile * row_bytes;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  auto load = [&](int q) {
    const size_t koff =
        static_cast<size_t>(list[lo + q / kSub]) * kTile * sizeof(T) +
        static_cast<size_t>(q % kSub) * 128;
    const uint32_t slot = ring + (q % kStages) * kStageBytes;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int id = tid + i * kThreads;
      const int r = id >> 3;
      const int c = id & 7;
      const char* src = (r < kRows ? xbase + r * row_bytes
                                   : wbase + (r - kRows) * row_bytes) +
                        koff + c * 16;
      cp_async16(slot + (r * kWords + ((c ^ (r & 7)) << 2)) * 4, src);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  Acc acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int g = lane >> 2;  // fragment row (A) / column (B) in its slice
  const int t = lane & 3;   // fragment word within a k step
  const int wm = warp & 1;   // warp's 32-row half of the block
  const int wn = warp >> 1;  // and its 64-column half
  for (int q = 0; q < total; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage q landed; stage q - 1's slot is free
    if (q + kStages - 1 < total) load(q + kStages - 1);
    cp_async_commit();
    const uint32_t* stage = smem + (q % kStages) * kStageWords;
    const uint32_t* sa = stage + (wm * 32 + g) * kWords;
    const uint32_t* sb = stage + (kRows + wn * 8 * kNT + g) * kWords;
    auto k_steps = [&](Acc(&dst)[2][kNT][4]) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // words 8s + t and 8s + t + 4 sit in chunks 2s and 2s + 1; every
        // fragment row is g modulo 8
        const int c0 = (((2 * s) ^ g) << 2) + t;
        const int c1 = (((2 * s + 1) ^ g) << 2) + t;
        uint32_t a[2][4], b[kNT][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t* r = sa + i * 16 * kWords;
          a[i][0] = r[c0];
          a[i][1] = r[8 * kWords + c0];
          a[i][2] = r[c1];
          a[i][3] = r[8 * kWords + c1];
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const uint32_t* r = sb + j * 8 * kWords;
          b[j][0] = r[c0];
          b[j][1] = r[c1];
        }
        warp_step(dst, a, b, Kind{});
      }
    };
    if constexpr (Kind::kPromote) {
      Acc stage_sum[2][kNT][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) stage_sum[i][j][r] = 0;
      k_steps(stage_sum);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += stage_sum[i][j][r];
    } else {
      k_steps(acc);
    }
  }

  const size_t N = static_cast<size_t>(nb) * kTile;
  const size_t col0 = static_cast<size_t>(n) * kTile + wn * 8 * kNT + 2 * t;
  float* pbase = part + static_cast<size_t>(split) * gridDim.y * kRows * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = row0 + wm * 32 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const size_t col = col0 + j * 8;
      if (splits == 1) {
        store2(out + row * N + col, acc[i][j][0], acc[i][j][1]);
        store2(out + (row + 8) * N + col, acc[i][j][2], acc[i][j][3]);
      } else {
        store2(pbase + row * N + col, acc[i][j][0], acc[i][j][1]);
        store2(pbase + (row + 8) * N + col, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

// out = part[0] + part[1] + ... in split order, rounded once to Out.
template <typename Out>
__global__ void reduce_splits(const float* __restrict__ part,
                              Out* __restrict__ out, size_t n4, int splits) {
  const float4* p = reinterpret_cast<const float4*>(part);
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 s = p[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v = p[k * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    store4(out + 4 * i, s);
  }
}

template <class Kind, bool kPerPair>
int launch(const void* x, const void* wt, const unsigned char* act,
           const unsigned char* occ, void* out, float* part, int m_rows,
           int mp, int nb, int kb, int splits, cudaStream_t stream) {
  using T = typename Kind::T;
  using Out = typename Kind::Out;
  if (mp <= 0 || nb <= 0 || kb <= 0)
    return static_cast<int>(cudaGetLastError());
  if (mp % kTile || splits < 1 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = event_matmul_kernel<Kind, kPerPair>;
  const int smem = kStages * kStageBytes + (kb + 1) * 4;
  static int smem_set = 0;  // per instance: raise the limit once
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  const dim3 grid(nb, mp / kRows, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), act, occ,
      static_cast<Out*>(out), part, m_rows, nb, kb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n4 = static_cast<size_t>(mp) * nb * kTile / 4;
  size_t blocks = (n4 + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  reduce_splits<Out><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      part, static_cast<Out*>(out), n4, splits);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBindThreads = 512;  // one 128 x 128 tile, 4 rows a pass
constexpr size_t kCarve = 256;      // alignment of each workspace part

size_t carved(size_t bytes) { return (bytes + kCarve - 1) / kCarve * kCarve; }

// The bind of one call, grid (kb, mp / 128): a block per 128 x 128 tile of
// the padded grid.  x (m_rows, k) at strides (sx0, sx1) and, for a pair,
// the float32 event mask m (m_rows, k) at (sm0, sm1); entries past
// (m_rows, k) read as zeros.  Writes act_x[tile]: some |x| > threshold and
// no NaN (a NaN makes PyTorch's amax NaN, and NaN > t is false); with
// xcopy, the tile into the zero-padded (mp, kb*128) copy; with m, the int8
// operand m8 = (m != 0) (NaN is an event) in its rows below m8_rows of a
// (., kb*128) layout, and act_m[tile], the OR of the tile's m8.  One pass
// over both operands; the block's flags meet in three barrier votes.
// Replaces no TPU kernel: it does the host's former pad, activity map and
// mask cast on the card.  Bounded by bytes (8 read an element of a pair,
// 1 to 5 written); a layer of 16 tiles is bounded by latency instead,
// while the card waits for the host most of the time.
template <class Kind>
__global__ void __launch_bounds__(kBindThreads)
event_bind(const typename Kind::Raw* __restrict__ x, long long sx0,
           long long sx1, const float* __restrict__ m, long long sm0,
           long long sm1, int m_rows, int k, float threshold,
           unsigned char* __restrict__ act_x,
           unsigned char* __restrict__ act_m,
           typename Kind::Raw* __restrict__ xcopy, int8_t* __restrict__ m8,
           int m8_rows) {
  using Raw = typename Kind::Raw;
  constexpr int kPass = kBindThreads / kTile;
  const size_t ld = static_cast<size_t>(gridDim.x) * kTile;
  const int col = blockIdx.x * kTile + threadIdx.x % kTile;
  const int row0 = blockIdx.y * kTile + threadIdx.x / kTile;
  const float thr = Kind::compared(threshold);
  bool event = false, nan = false, m_event = false;
#pragma unroll 8
  for (int i = 0; i < kTile; i += kPass) {
    const int row = row0 + i;
    const bool in = row < m_rows && col < k;
    const Raw v = in ? x[row * sx0 + col * sx1] : Raw(0);
    const float a = Kind::magnitude(v);
    event |= a > thr;
    nan |= a != a;
    if (xcopy != nullptr) xcopy[row * ld + col] = v;
    if (m != nullptr) {
      const bool e = (in ? m[row * sm0 + col * sm1] : 0.0f) != 0.0f;
      m_event |= e;
      if (row < m8_rows) m8[row * ld + col] = e;
    }
  }
  const bool any_event = __syncthreads_or(event);
  const bool any_nan = __syncthreads_or(nan);
  const bool any_m = __syncthreads_or(m_event);
  if (threadIdx.x == 0) {
    const size_t tile = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    act_x[tile] = any_event && !any_nan;
    if (act_m != nullptr) act_m[tile] = any_m;
  }
}

// One call: the bind, the value product (1-D without occ) and, with m,
// the int8 counter product (1-D without occ8), each with its reduction.
// The workspace is carved in the order of the wrapper's sizes: act_x,
// act_m, the copy of x, m8, the split partials (shared by both products,
// which run one after the other on the stream).
template <class Kind>
int pair(const void* x, long long sx0, long long sx1, const float* m,
         long long sm0, long long sm1, const void* wt,
         const unsigned char* occ, const void* wt8,
         const unsigned char* occ8, void* y, float* macs, void* ws,
         long long ws_bytes, int m_rows, int k, int nb, int splits,
         float threshold, int pad_x, int pad_m, cudaStream_t stream) {
  using Raw = typename Kind::Raw;
  if (m_rows < 0 || k < 0 || nb <= 0 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kb = (k + kTile - 1) / kTile;
  const int mp = (m_rows + kTile - 1) / kTile * kTile;
  const size_t np = static_cast<size_t>(nb) * kTile;
  if (mp == 0) return static_cast<int>(cudaGetLastError());
  if (kb == 0) {  // an empty contraction: exact zeros
    cudaError_t err = cudaMemsetAsync(
        y, 0, mp * np * sizeof(typename Kind::Out), stream);
    if (err == cudaSuccess && m != nullptr)
      err = cudaMemsetAsync(macs, 0, mp * np * sizeof(float), stream);
    return static_cast<int>(err);
  }
  const size_t kp = static_cast<size_t>(kb) * kTile;
  const bool rows_ok = k % kTile == 0 && m_rows % kRows == 0;
  const bool in_place = rows_ok && sx1 == 1 && sx0 == k &&
                        reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if ((!pad_x && !in_place) || (m != nullptr && !pad_m && !rows_ok) ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  char* const base = static_cast<char*>(ws);
  size_t used = 0;
  auto take = [&](size_t bytes) {
    char* p = base + used;
    used += carved(bytes);
    return p;
  };
  const size_t tiles = static_cast<size_t>(mp / kTile) * kb;
  auto* act_x = reinterpret_cast<unsigned char*>(take(tiles));
  unsigned char* act_m =
      m ? reinterpret_cast<unsigned char*>(take(tiles)) : nullptr;
  Raw* xcopy = pad_x ? reinterpret_cast<Raw*>(take(mp * kp * sizeof(Raw)))
                     : nullptr;
  const int m8_rows = pad_m ? mp : m_rows;
  int8_t* m8 = m ? reinterpret_cast<int8_t*>(take(m8_rows * kp)) : nullptr;
  float* part = splits > 1 ? reinterpret_cast<float*>(
                                 take(splits * mp * np * sizeof(float)))
                           : nullptr;
  if (used > static_cast<size_t>(ws_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  event_bind<Kind><<<dim3(kb, mp / kTile), kBindThreads, 0, stream>>>(
      static_cast<const Raw*>(x), sx0, sx1, m, sm0, sm1, m_rows, k,
      threshold, act_x, act_m, xcopy, m8, m8_rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* xk = pad_x ? static_cast<const void*>(xcopy) : x;
  const int rc =
      occ ? launch<Kind, true>(xk, wt, act_x, occ, y, part, m_rows, mp, nb,
                                kb, splits, stream)
          : launch<Kind, false>(xk, wt, act_x, nullptr, y, part, m_rows, mp,
                                 nb, kb, splits, stream);
  if (rc != 0 || m == nullptr) return rc;
  return occ8 ? launch<I8, true>(m8, wt8, act_m, occ8, macs, part, m_rows,
                                  mp, nb, kb, splits, stream)
              : launch<I8, false>(m8, wt8, act_m, nullptr, macs, part,
                                   m_rows, mp, nb, kb, splits, stream);
}

}  // namespace

// One library call for one layer's products.  The value operand x
// (m_rows, k) at element strides (sx0, sx1), of one kind -- 0 float32
// (3xTF32), 1 bfloat16, 2 int8 (0/1 masks) -- with its weights wt
// (nb*128, kb*128) transposed (K-major) and zero-padded, and occ (kb, nb),
// 1 where a weight tile holds a nonzero (null: the 1-D product).  For a
// pair, m (m_rows, k) float32 wire events at (sm0, sm1), counted against
// the int8 nnz mask wt8 (same layout) and occ8.  y (mp, nb*128) in the
// kind's output type (float32, bfloat16, float32) and macs (mp, nb*128)
// float32, mp = m_rows rounded up to 128; their first (m_rows, nb*128)
// rows are the products.  ws: 16-byte aligned scratch of ws_bytes.  pad_x:
// copy x into a zero-padded layout (required unless k % 128 == 0, m_rows %
// 64 == 0 and x is packed row-major and 16-byte aligned); pad_m: the same
// for the int8 operand.  threshold: an event is |x| > threshold.  Launches
// the bind, then each product and its split reduction on `stream`, and
// returns the first cudaError_t.
extern "C" int event_matmul_pair_launch(
    const void* x, long long sx0, long long sx1, const float* m,
    long long sm0, long long sm1, const void* wt, const unsigned char* occ,
    const void* wt8, const unsigned char* occ8, void* y, float* macs,
    void* ws, long long ws_bytes, int m_rows, int k, int nb, int splits,
    int kind, float threshold, int pad_x, int pad_m, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return pair<F32>(x, sx0, sx1, m, sm0, sm1, wt, occ, wt8, occ8, y, macs,
                       ws, ws_bytes, m_rows, k, nb, splits, threshold, pad_x,
                       pad_m, s);
    case 1:
      return pair<BF16>(x, sx0, sx1, m, sm0, sm1, wt, occ, wt8, occ8, y, macs,
                        ws, ws_bytes, m_rows, k, nb, splits, threshold, pad_x,
                        pad_m, s);
    case 2:
      return pair<I8>(x, sx0, sx1, m, sm0, sm1, wt, occ, wt8, occ8, y, macs,
                      ws, ws_bytes, m_rows, k, nb, splits, threshold, pad_x,
                      pad_m, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
