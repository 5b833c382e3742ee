// Block-sparse event-driven matmuls for Hopper (sm_90a): two tile bodies,
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
// Each block builds its own list (the Hopper form of the TPU's scalar
// prefetch): warp 0 reads the (Mb, Kb) activity bytes and, for the joint
// kernel, the (Kb, Nb) occupancy bytes, and compacts the live k tiles in
// ascending order into shared memory with a ballot and a popcount prefix,
// 32 k tiles per step.  Where the output tiles alone would leave the card
// under one wave, the wrapper asks for `splits` blocks per tile: block s
// takes live entries [s*cnt/splits, (s+1)*cnt/splits) of the list and
// writes a float32 partial; a second pass (reduce_splits) sums the
// partials in split order.  No atomics and a fixed k order: repeated
// launches give the same bits.
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
//           its truncations do not add up.  Within 4.14e-6 of the float64
//           product at K = 8,512 (the plain float32 product: 1.9e-5); the
//           dropped a_lo*b_lo term is ~2^-22 relative.  float32 out.
//   BF16 -- bfloat16 operands, float32 accumulation, rounded once at the
//           store; bfloat16 out.
//   I8   -- int8 0/1 masks (the counter products), int32 accumulation,
//           converted to float32 at the store: exact while a sum stays
//           below 2^24.
//
// What bounds F32 on this card: operations, 3 TF32 products a MAC at the
// 495 TFLOP/s rate, and behind them the L2's bandwidth, since the weights'
// two halves double the bytes a tile reads.  Its body (wgmma, below)
// answers each limit of the first tensor-core design, which ran at a
// third of that rate on mma.sync:
//
// * wgmma.mma_async m64n128k8 .tf32, the only way to Hopper's full tensor
//   rate.  A block owns a 128 x 128 output tile: two consumer warpgroups
//   of 64 rows, each holding its tile's float32 accumulator and the
//   stage's tensor-core sum (64 + 64 registers a thread, after setmaxnreg
//   moves registers from the producer to them).
// * The weights' TF32 halves are made once per layer by the wrapper
//   (KernelWeights), not re-split on every k step of every call: B comes
//   from shared memory through descriptors.  x is loaded raw and split in
//   the consumers' registers, where it enters the products as A.
// * One producer thread keeps a 4-stage ring full through TMA: a stage is
//   32 floats of k for the 128 x rows and the 128 rows of each weight half
//   (48 KB, 128-byte swizzled by the copy, conflict-free for the A loads),
//   handed over by a full and an empty mbarrier a stage, so no barrier
//   stops the whole block.  Rows past M arrive as zeros (TMA's bounds), so
//   x is read in place at M = 448.
// * Blocks walk the m-blocks of one n tile together, so each weight tile
//   is read from device memory once and from L2 by the others.
//
// BF16 and I8 run on the mma.sync body: m16n8k16 bf16 and m16n8k32 s8
// fragments, read at the same 32-bit word positions (a k step is 8 words),
// a 4-stage cp.async ring of 24 KB stages (64 x rows, 128 w rows, 16-byte
// chunks XOR-swizzled by row), 64-row output tiles of four warps (32 x 64
// outputs each), two blocks an SM.  What bounds them: bytes for I8 (the
// float32 output outweighs its int8 operands) and for sparse BF16,
// operations for dense BF16.
//
// The bind (event_bind) runs first, in the same library call as the
// products it feeds: one pass over a layer's value operand and wire-event
// mask that writes both activity maps and the int8 counter operand, and a
// zero-padded copy of an operand only where a product would read past it
// (K not a multiple of 128, M not of 64, or x not packed and 16-byte
// aligned); every other operand is read in place.  The mma.sync body never
// reads rows past M: their 64-row blocks find an empty list.  It replaces
// the dozen PyTorch ops a layer took to pad, map and cast on the host's
// side.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

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

// For the bind: Raw is the operand's bits, magnitude(v) its |v| as
// PyTorch's abs gives it (int8 wraps: |-128| = -128), compared(t) the
// threshold as PyTorch compares a tensor of the kind with a float (in
// bfloat16 for bfloat16).  F32's products run on the wgmma body, the other
// two kinds' on the mma.sync body (Acc: its accumulator).
struct F32 {
  using Out = float;
  using Raw = uint32_t;
  static __device__ float magnitude(Raw v) { return fabsf(__uint_as_float(v)); }
  static __device__ float compared(float t) { return t; }
};
struct BF16 {
  using T = __nv_bfloat16;
  using Acc = float;
  using Out = __nv_bfloat16;
  using Raw = uint16_t;
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

// The mma.sync body, BF16 and I8.
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
      warp_step(acc, a, b, Kind{});
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

// ---------------------------------------------- the float32 body on wgmma
//
// Grid (mp / 128, nb, splits), 384 threads: warpgroup 0 produces (one
// thread issues the TMA loads), warpgroups 1 and 2 consume, 64 output rows
// each, all 128 columns of the n tile.  x (x_rows, kb*128) and the
// weights' halves (2, nb*128, kb*128) -- hi rows, then lo rows -- are read
// through tensor maps as 128-row boxes of 32 floats (128 B, the swizzle
// width); rows at or past x_rows arrive as zeros.
constexpr int kWRows = 128;              // output rows a block
constexpr int kWThreads = 384;           // producer + two consumer groups
constexpr int kWStages = 4;              // depth of the ring
constexpr int kWBox = kTile * 128;       // one 128-row, 128-byte box
constexpr int kWStageBytes = 3 * kWBox;  // x, w hi, w lo: 48 KB
constexpr int kWRing = kWStages * kWStageBytes;
constexpr int kWSteps = kTile / 32;      // stages a k tile

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` at (c0 = k, c1 = row) into shared memory at dst,
// counted on the barrier's transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The shared-memory descriptor of a K-major box: rows of 128 B, eight
// rows (1,024 B) a swizzle atom, 128-byte swizzle.  Adding 2 advances it
// by 32 B, one k step of 8 floats.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// d (+)= a * b over one k step of 8: the warpgroup's 64 x 128 tile, A
// (its 64 x 8 rows) from registers as mma.m16n8k8 fragments a warp, B
// (128 x 8) from shared memory.  scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Keeps the compiler from moving register traffic across the asynchronous
// products that read or write r.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <bool kPerPair>
__global__ void __launch_bounds__(kWThreads, 1)
event_matmul_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const unsigned char* __restrict__ act,
                          const unsigned char* __restrict__ occ,
                          float* __restrict__ out, float* __restrict__ part,
                          int nb, int kb) {
  extern __shared__ unsigned char wsmem[];
  // the ring on a 1,024-byte boundary (the swizzle atom), then the full
  // and empty barriers of each stage, then the live list
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wsmem));
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const unsigned char* base = wsmem + (ring - raw);
  const uint32_t full = ring + kWRing;
  const uint32_t empty = full + 8 * kWStages;
  int* list = reinterpret_cast<int*>(wsmem + (ring - raw) + kWRing +
                                     16 * kWStages);

  const int mblk = blockIdx.x;
  const int n = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (warp == 0) {
    int count = 0;
    const unsigned char* arow = act + static_cast<size_t>(mblk) * kb;
    for (int b = 0; b < kb; b += 32) {
      const int k = b + lane;
      bool live = k < kb && arow[k] != 0;
      if (kPerPair) live = live && occ[static_cast<size_t>(k) * nb + n] != 0;
      const unsigned bits = __ballot_sync(0xffffffffu, live);
      if (live) list[count + __popc(bits & ((1u << lane) - 1u))] = k;
      count += __popc(bits);
    }
    if (lane == 0) {
      list[kb] = count;
      for (int s = 0; s < kWStages; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  const int cnt = list[kb];
  const int lo = static_cast<int>(static_cast<long long>(split) * cnt / splits);
  const int hi =
      static_cast<int>(static_cast<long long>(split + 1) * cnt / splits);
  const int total = (hi - lo) * kWSteps;

  if (warp < 4) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int q = 0; q < total; ++q) {
        const int s = q % kWStages;
        mbar_wait(empty + 8 * s, ((q / kWStages) & 1) ^ 1);
        const uint32_t dst = ring + s * kWStageBytes;
        const int k = list[lo + q / kWSteps] * kTile + (q % kWSteps) * 32;
        mbar_expect_tx(full + 8 * s, kWStageBytes);
        tma_load(dst, &xmap, k, mblk * kTile, full + 8 * s);
        tma_load(dst + kWBox, &wmap, k, n * kTile, full + 8 * s);
        tma_load(dst + 2 * kWBox, &wmap, k, (nb + n) * kTile, full + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int row = (warp - 4) * 16 + (lane >> 2);  // 0..127, and row + 8
  const int g = lane >> 2;                        // row % 8: the swizzle
  const int t = lane & 3;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.0f;
  for (int q = 0; q < total; ++q) {
    const int s = q % kWStages;
    mbar_wait(full + 8 * s, (q / kWStages) & 1);
    // A: this thread's fragments of the stage's four k steps, split here
    const uint32_t* sa =
        reinterpret_cast<const uint32_t*>(base + s * kWStageBytes) +
        row * kWords;
    uint32_t ah[kWSteps][4], al[kWSteps][4];
#pragma unroll
    for (int ks = 0; ks < kWSteps; ++ks) {
      const int c0 = (((2 * ks) ^ g) << 2) + t;
      const int c1 = (((2 * ks + 1) ^ g) << 2) + t;
      split_tf32(sa[c0], ah[ks][0], al[ks][0]);
      split_tf32(sa[8 * kWords + c0], ah[ks][1], al[ks][1]);
      split_tf32(sa[c1], ah[ks][2], al[ks][2]);
      split_tf32(sa[8 * kWords + c1], ah[ks][3], al[ks][3]);
    }
    const uint32_t stage = ring + s * kWStageBytes;
    const uint64_t bh = sw128_desc(stage + kWBox);
    const uint64_t bl = sw128_desc(stage + 2 * kWBox);
    fence_regs(sum);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kWSteps; ++ks) {
      wgmma_tf32(sum, al[ks], bh + 2 * ks, ks);  // the stage's sum from 0
      wgmma_tf32(sum, ah[ks], bl + 2 * ks, 1);
      wgmma_tf32(sum, ah[ks], bh + 2 * ks, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(sum);
    fence_regs(ah);  // the products read A until the wait
    fence_regs(al);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += sum[i];
  }

  const size_t N = static_cast<size_t>(nb) * kTile;
  float* dst = splits == 1 ? out
                           : part + static_cast<size_t>(split) * gridDim.x *
                                        kWRows * N;
  float* r0 = dst + (static_cast<size_t>(mblk) * kWRows + row) * N +
              static_cast<size_t>(n) * kTile + 2 * t;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    store2(r0 + 8 * j, acc[4 * j], acc[4 * j + 1]);
    store2(r0 + 8 * N + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (rows, kp) row-major float32 matrix as the kernel's boxes: 32 floats
// of k by 128 rows, 128-byte swizzled, zeros past the last row.
bool box_map(CUtensorMap* map, const void* a, size_t rows, size_t kp) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {kp, rows};
  const cuuint64_t strides[1] = {kp * sizeof(float)};
  const cuuint32_t box[2] = {32, kWRows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(a), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kPerPair>
int launch_wgmma(const void* x, int x_rows, const void* wsplit,
                 const unsigned char* act, const unsigned char* occ,
                 float* out, float* part, int mp, int nb, int kb, int splits,
                 cudaStream_t stream) {
  if (mp <= 0 || nb <= 0 || kb <= 0)
    return static_cast<int>(cudaGetLastError());
  if (mp % kWRows || splits < 1 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  const size_t kp = static_cast<size_t>(kb) * kTile;
  if (!box_map(&xmap, x, x_rows, kp) ||
      !box_map(&wmap, wsplit, 2 * static_cast<size_t>(nb) * kTile, kp))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = event_matmul_kernel_wgmma<kPerPair>;
  const int smem = 1024 + kWRing + 16 * kWStages + (kb + 1) * 4;
  static int smem_set = 0;  // per instance: raise the limit once
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  kernel<<<dim3(mp / kWRows, nb, splits), kWThreads, smem, stream>>>(
      xmap, wmap, act, occ, out, part, nb, kb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n4 = static_cast<size_t>(mp) * nb * kTile / 4;
  size_t blocks = (n4 + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  reduce_splits<float><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      part, out, n4, splits);
  return static_cast<int>(cudaGetLastError());
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
// A float32 value product runs on the wgmma body (wt: the weights' (2,
// nb*128, kb*128) TF32 halves), the other kinds' and the counter on the
// mma.sync body; `splits` and `splits_m` are the two products' blocks a
// tile.  The workspace is carved in the order of the wrapper's sizes:
// act_x, act_m, the copy of x, m8, the split partials (shared by both
// products, which run one after the other on the stream).
template <class Kind>
int pair(const void* x, long long sx0, long long sx1, const float* m,
         long long sm0, long long sm1, const void* wt,
         const unsigned char* occ, const void* wt8,
         const unsigned char* occ8, void* y, float* macs, void* ws,
         long long ws_bytes, int m_rows, int k, int nb, int splits,
         int splits_m, float threshold, int pad_x, int pad_m,
         cudaStream_t stream) {
  using Raw = typename Kind::Raw;
  if (m_rows < 0 || k < 0 || nb <= 0 || splits < 1 || splits_m < 1)
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
  const int most = splits > splits_m || m == nullptr ? splits : splits_m;
  float* part = most > 1 ? reinterpret_cast<float*>(
                               take(most * mp * np * sizeof(float)))
                         : nullptr;
  if (used > static_cast<size_t>(ws_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  event_bind<Kind><<<dim3(kb, mp / kTile), kBindThreads, 0, stream>>>(
      static_cast<const Raw*>(x), sx0, sx1, m, sm0, sm1, m_rows, k,
      threshold, act_x, act_m, xcopy, m8, m8_rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* xk = pad_x ? static_cast<const void*>(xcopy) : x;
  int rc;
  if constexpr (std::is_same<Kind, F32>::value) {
    const int x_rows = pad_x ? mp : m_rows;
    float* yf = static_cast<float*>(y);
    rc = occ ? launch_wgmma<true>(xk, x_rows, wt, act_x, occ, yf, part, mp,
                                  nb, kb, splits, stream)
             : launch_wgmma<false>(xk, x_rows, wt, act_x, nullptr, yf, part,
                                   mp, nb, kb, splits, stream);
  } else {
    rc = occ ? launch<Kind, true>(xk, wt, act_x, occ, y, part, m_rows, mp,
                                  nb, kb, splits, stream)
             : launch<Kind, false>(xk, wt, act_x, nullptr, y, part, m_rows,
                                   mp, nb, kb, splits, stream);
  }
  if (rc != 0 || m == nullptr) return rc;
  return occ8 ? launch<I8, true>(m8, wt8, act_m, occ8, macs, part, m_rows,
                                  mp, nb, kb, splits_m, stream)
              : launch<I8, false>(m8, wt8, act_m, nullptr, macs, part,
                                   m_rows, mp, nb, kb, splits_m, stream);
}

}  // namespace

// One library call for one layer's products.  The value operand x
// (m_rows, k) at element strides (sx0, sx1), of one kind -- 0 float32
// (3xTF32), 1 bfloat16, 2 int8 (0/1 masks) -- with its weights wt
// (nb*128, kb*128) transposed (K-major) and zero-padded -- for float32
// its TF32 halves (2, nb*128, kb*128), hi then lo -- and occ (kb, nb), 1
// where a weight tile holds a nonzero (null: the 1-D product).  splits and
// splits_m: blocks a tile of the value product (128-row tiles for
// float32, else 64) and of the counter product (64-row tiles).  For a
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
    int splits_m, int kind, float threshold, int pad_x, int pad_m,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return pair<F32>(x, sx0, sx1, m, sm0, sm1, wt, occ, wt8, occ8, y, macs,
                       ws, ws_bytes, m_rows, k, nb, splits, splits_m,
                       threshold, pad_x, pad_m, s);
    case 1:
      return pair<BF16>(x, sx0, sx1, m, sm0, sm1, wt, occ, wt8, occ8, y, macs,
                        ws, ws_bytes, m_rows, k, nb, splits, splits_m,
                        threshold, pad_x, pad_m, s);
    case 2:
      return pair<I8>(x, sx0, sx1, m, sm0, sm1, wt, occ, wt8, occ8, y, macs,
                      ws, ws_bytes, m_rows, k, nb, splits, splits_m,
                      threshold, pad_x, pad_m, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The split the wgmma body makes of each x word, alone: hi and lo of n
// float32 words, so that tests can hold it to cvt.rna's bits and to the
// plain split of the weights' halves.
__global__ void tf32_split_kernel(const uint32_t* __restrict__ x,
                                  uint32_t* __restrict__ hi,
                                  uint32_t* __restrict__ lo, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) split_tf32(x[i], hi[i], lo[i]);
}

extern "C" int tf32_split_launch(const void* x, void* hi, void* lo,
                                 long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  tf32_split_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(hi),
      static_cast<uint32_t*>(lo), n);
  return static_cast<int>(cudaGetLastError());
}
