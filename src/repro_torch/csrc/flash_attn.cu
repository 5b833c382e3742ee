// Flash attention (online softmax, GQA-aware) for Hopper (sm_90a), on the
// TF32 tensor cores as 3xTF32.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attn/kernel.py:29.  Same contract: q (B, Sq, H,
// hd), k and v (B, Skv, K, hd), float32, query head h reading KV head
// h / (H/K) (the query heads of one KV head are contiguous); scores are
// (q * scale) . k, optionally soft-capped (cap * tanh(s / cap), the
// precise tanhf), masked with the finite NEG_INF = -1e30 where causal
// (q_pos < k_pos), outside a local window (q_pos - k_pos >= window) or at
// k_pos >= kv_len; the running (m, l, acc) stay in float32 and the output
// is acc / max(l, 1e-30).  Sq and Skv are the true lengths: K/V rows past
// Skv are zero-filled in shared memory and masked through kv_len (the
// wrapper passes Skv), query rows past Sq are computed on zeros and never
// stored, so the wrapper copies and pads nothing.
//
// What bounds it on this card: operations.  Each (query, key) pair costs
// 2 * hd multiply-adds (scores, then P.V); as 3xTF32 that is three TF32
// products per multiply-add at 495 TFLOP/s, against q, k, v and o moved
// once at 3.35 TB/s: from a few hundred keys on, the work sits far above
// the memory roof.  A one-pass TF32 product would be 3x cheaper but keeps
// only 10 mantissa bits: on peaked scores (std 4, as trained attention
// has) it misses float32 by ~3e-3, past the frontend's 2e-4 probe limit,
// while 3xTF32 stays within 1e-5 (tests/test_torch_flash.py emulates
// both).
//
// Design:
// * Four 16-row strips per 64-row q tile, one block per (batch * query
//   head, q tile); a strip is the m16 of mma.sync.m16n8k8 TF32.  Both
//   products run on it as 3xTF32 (tf32_mma.cuh; hi rounded by integer
//   operations, which made the kernel faster than cvt.rna did): S =
//   Q.K^T in stages of 32 of hd, each summed from zero in the tensor core
//   and added to S in float32 (a running tensor-core sum truncates one
//   way; one chain over hd 64 drifted further from a float64 oracle);
//   P.V as a fresh partial per KV tile and 8 output columns, acc = acc *
//   alpha + partial in float32 registers.
// * The softmax lives in the accumulator layout: a thread holds rows g and
//   g + 8 of its strip at keys 8j + 2t, 8j + 2t + 1; the row max reduces
//   over the quad of threads sharing g (xor 1, 2), l is kept per thread
//   and reduced once at the end.  exp2f takes (s - m) * log2(e), applied
//   after the softcap and the mask (the cap acts on q.k * scale, so
//   log2(e) is never folded into q).
// * P stays in registers.  P.V sums over keys, so each k step of 8 keys
//   permutes them: A column t <-> key 2t, A column t + 4 <-> key 2t + 1.
//   The accumulator (c0, c1, c2, c3) = P(g, 2t), P(g, 2t+1), P(g+8, 2t),
//   P(g+8, 2t+1) is then the A fragment {c0, c2, c1, c3} with no shuffle,
//   and the B fragment reads V rows 2t (b0) and 2t + 1 (b1) of the step.
//   Q.K^T sums over hd and permutes it the same way within each pair of k
//   steps (thread t's float4 at column 16 kp + 4t feeds A/B columns t and
//   t + 4 of both steps), and P.V's output slice 4G + u reads V column
//   32G + 4g + u, so every fragment is one 16-byte shared-memory read and
//   a thread's outputs are two float4 runs per 32 columns.
// * K and V stream through a two-stage cp.async ring: tile i + 1 is in
//   flight while tile i is multiplied; one barrier per tile.  Rows are HD
//   floats (hd zero-filled up to the instance's HD; rows past Skv
//   zero-filled), 16-byte chunks XOR-swizzled by row so that the fragment
//   reads are conflict-free.  hd % 4 != 0 (or a pointer not 16-byte
//   aligned) takes the instance that copies 4 bytes at a time.
// * Q is scaled and stored once.  HD 32 and 64 take 64-key tiles and keep
//   Q's hi/lo fragments in registers for the whole KV loop (64 registers
//   at HD 64; 80 KB of shared memory, two blocks per SM).  HD 128 and 256
//   keep Q in shared memory and split it on each read, with 32-key tiles:
//   at HD 256 a 64-key K+V stage is 128 KB and two do not fit beside Q's
//   64 KB, while two 32-key stages do (192 KB, one block per SM; HD 128:
//   96 KB, two).  With one block per SM, HD 256 runs two warps per strip
//   (eight warps): each takes half of every tile's keys with its own
//   online softmax, and the second hands (m, l, acc) to the first through
//   the ring at the end, as a split-KV merge.  acc alone is 128 registers
//   a thread there, so two warps per SM sub-partition hide the latency
//   that one could not (with one warp a strip, gemma2's global site took
//   far longer).
// * nvcc -Xptxas -v (CUDA 12.8, sm_90a), registers and local-memory
//   spills per instance, and dynamic shared memory: HD 32 156, none,
//   40 KB; HD 64 238, none, 80 KB; HD 128 184 to 186, none, 96 KB; HD 256
//   255, 80 bytes (nine accumulator words, reloaded and stored once per
//   KV tile), 192 KB; the same for the 16- and 4-byte-copy instances.  The load loops stay rolled: unrolled, their
//   hoisted addresses spilled at HD 64.
// * Tiles wholly in the causal future, wholly behind the window or wholly
//   at or past kv_len are never loaded; only tiles that a mask can touch
//   (diagonal, window edge, kv_len edge) evaluate it per element.  A row
//   with no live key in a loaded tile takes p = 1 from NEG_INF - NEG_INF
//   and a later live tile's (or the other warp's) alpha = 0 wipes it, as
//   on the TPU.  Causal grids run the heaviest q tiles first.  Whisper's
//   decoder site (S 448, causal) fills 56 blocks, under one wave, and
//   takes no KV split: it already runs below the library call.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block, 16 per strip
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// One instance: head dims up to HD (zero-filled above hd).
template <int HD>
struct Shape {
  static constexpr int kBK = HD <= 64 ? 64 : 32;   // keys per KV tile
  static constexpr int kSplit = HD == 256 ? 2 : 1;  // warps per strip
  static constexpr int kThreads = 128 * kSplit;
  static constexpr int kKeys = kBK / kSplit;       // keys per warp per tile
  static constexpr int kNT = kKeys / 8;  // 8-key slices of S = k steps of P.V
  static constexpr bool kQRegs = HD <= 64;         // Q hi/lo in registers
  static constexpr int kKP = HD / 16;    // k-step pairs of Q.K^T
  static constexpr int kG = HD / 32;     // 32-column groups of the output
  static constexpr int kStage = 2 * kBK * HD;      // floats: K tile, V tile
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(kBQ) * HD + 2 * kStage);
};

// Word offset of chunk c (16 bytes) of row r in a tile of HD-float rows,
// XOR-swizzled so that fragment reads are conflict-free: Q and K rows are
// read as 4-chunk runs by rows g and g + 1 (odd rows XOR 4), V rows down
// rows 2t and 2t + 1 (XOR r & 6).
template <int HD, bool kV>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * HD + ((c ^ (kV ? r & 6 : (r & 1) << 2)) << 2);
}

// kRows x hd floats at src (row stride `stride`) into the swizzled tile at
// shared address dst, asynchronously; rows >= valid and columns >= hd are
// zero-filled.  kVec: 16-byte chunks (hd % 4 == 0, src 16-byte aligned),
// else 4-byte words.  Thread i copies units i, i + kThreads, ... in rows
// of kUnits, in a loop kept rolled (see the register note above).
template <int HD, int kThreads, int kRows, bool kV, bool kVec>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src,
                                          size_t stride, int valid, int hd) {
  constexpr int kW = kVec ? 4 : 1;         // floats per unit
  constexpr int kUnits = HD / kW;          // units per row
#pragma unroll 1
  for (int it = 0; it < kRows * kUnits / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kUnits, d = (i % kUnits) * kW;
    const bool ok = r < valid && d < hd;
    const uint32_t at = dst + 4 * (chunk_at<HD, kV>(r, d >> 2) + (d & 3));
    const float* from = ok ? src + r * stride + d : src;
    if constexpr (kVec)
      cp_async16_zfill(at, from, ok ? 16 : 0);
    else
      cp_async4_zfill(at, from, ok ? 4 : 0);
  }
}

// The 64 x hd query tile, times scale, into the swizzled tile qs.
template <int HD, int kThreads, bool kVec>
__device__ __forceinline__ void load_q(float* qs, const float* src,
                                       size_t stride, int valid, int hd,
                                       float scale) {
  constexpr int kC = HD / 4;
#pragma unroll 1
  for (int it = 0; it < kBQ * kC / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kC, d = (i % kC) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (kVec) {
      if (r < valid && d < hd)
        x = *reinterpret_cast<const float4*>(src + r * stride + d);
    } else {
      const float* row = src + r * stride + d;
      if (r < valid && d < hd) x.x = row[0];
      if (r < valid && d + 1 < hd) x.y = row[1];
      if (r < valid && d + 2 < hd) x.z = row[2];
      if (r < valid && d + 3 < hd) x.w = row[3];
    }
    *reinterpret_cast<float4*>(qs + chunk_at<HD, false>(r, d >> 2)) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
}

// Q.K^T permutes hd inside each pair of k steps (16 columns from 16 kp):
// thread t's float4 at 16 kp + 4t holds A/B columns t, t + 4 of step 0
// (.x, .y) and of step 1 (.z, .w).  `base` is the thread's word offset of
// pair 0 in row g (chunk t, swizzled) for even kp, `base_odd` for odd kp.
__device__ __forceinline__ float4 pair_at(const float* tile, int base,
                                          int base_odd, int kp) {
  return *reinterpret_cast<const float4*>(tile + 16 * kp +
                                          (kp & 1 ? base_odd : base));
}

// Split A fragments of k-step pair kp from rows g (x) and g + 8 (y).
__device__ __forceinline__ void a_fragments(float4 x, float4 y,
                                            uint32_t (&hi)[2][4],
                                            uint32_t (&lo)[2][4]) {
  split_tf32_int(x.x, hi[0][0], lo[0][0]);
  split_tf32_int(y.x, hi[0][1], lo[0][1]);
  split_tf32_int(x.y, hi[0][2], lo[0][2]);
  split_tf32_int(y.y, hi[0][3], lo[0][3]);
  split_tf32_int(x.z, hi[1][0], lo[1][0]);
  split_tf32_int(y.z, hi[1][1], lo[1][1]);
  split_tf32_int(x.w, hi[1][2], lo[1][2]);
  split_tf32_int(y.w, hi[1][3], lo[1][3]);
}

// d += a.b as 3xTF32, small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD, bool kVec>
__global__ void __launch_bounds__(Shape<HD>::kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq,
                  int Skv, int H, int K, int hd, int causal, int window,
                  float softcap, int kv_len, float scale) {
  using S = Shape<HD>;
  constexpr int kBK = S::kBK, kNT = S::kNT, kKP = S::kKP, kG = S::kG;
  constexpr int kThreads = S::kThreads;
  extern __shared__ __align__(128) float smem[];
  float* qs = smem;                     // [kBQ][HD], q * scale
  float* ring = smem + kBQ * HD;        // stage s: K [kBK][HD], V [kBK][HD]

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / K);
  const int q0 = qt * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp & 3) * 16;     // the warp's strip of query rows
  const int key0 = (warp >> 2) * S::kKeys;  // and its keys in each tile
  const size_t q_row = static_cast<size_t>(H) * hd;    // position stride
  const size_t kv_row = static_cast<size_t>(K) * hd;
  const float* qb = q + (static_cast<size_t>(b) * Sq + q0) * q_row
                  + static_cast<size_t>(h) * hd;
  const float* kb = k + static_cast<size_t>(b) * Skv * kv_row
                  + static_cast<size_t>(kvh) * hd;
  const float* vb = v + static_cast<size_t>(b) * Skv * kv_row
                  + static_cast<size_t>(kvh) * hd;
  const int kvl = min(kv_len, Skv);

  // live KV tiles: none wholly in the causal future, behind the window of
  // the block's first query, or at or past kv_len
  int kt_lo = 0, kt_hi = (kvl + kBK - 1) / kBK;
  if (causal) kt_hi = min(kt_hi, (q0 + kBQ - 1) / kBK + 1);
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / kBK;

  const uint32_t ring_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kBK;
    const uint32_t dst = ring_s + stage * S::kStage * 4;
    load_tile<HD, kThreads, kBK, false, kVec>(dst, kb + k0 * kv_row, kv_row,
                                              Skv - k0, hd);
    load_tile<HD, kThreads, kBK, true, kVec>(dst + kBK * HD * 4,
                                             vb + k0 * kv_row, kv_row,
                                             Skv - k0, hd);
  };
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();
  load_q<HD, kThreads, kVec>(qs, qb, q_row, Sq - q0, hd, scale);
  __syncthreads();

  // per-thread word offsets: Q and K pair reads (row g: chunk t, XOR 4 on
  // odd g, so kp ^ (g & 1) moves by +-16 words), V reads (row key0 + 2t,
  // chunk g ^ 2t)
  const int qk_even = g * HD + 4 * t + 16 * (g & 1);
  const int qk_odd = g * HD + 4 * t - 16 * (g & 1);
  const int v_base = (key0 + 2 * t) * HD + 4 * (g ^ (2 * t));
  const float* qrow = qs + row0 * HD;

  uint32_t qh[S::kQRegs ? kKP : 1][2][4], ql[S::kQRegs ? kKP : 1][2][4];
  if constexpr (S::kQRegs) {
#pragma unroll
    for (int kp = 0; kp < kKP; ++kp)
      a_fragments(pair_at(qrow, qk_even, qk_odd, kp),
                  pair_at(qrow + 8 * HD, qk_even, qk_odd, kp), qh[kp],
                  ql[kp]);
  }

  float acc[HD / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int it = kt - kt_lo;
    const int k0 = kt * kBK;
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; the other stage's readers are done
    if (kt + 1 < kt_hi) load_kv(kt + 1, (it + 1) & 1);
    cp_async_commit();
    const float* ks = ring + (it & 1) * S::kStage + key0 * HD;
    const float* vs = ring + (it & 1) * S::kStage + kBK * HD;

    // S = (q * scale) . K^T for the warp's keys, 3xTF32; each stage of two
    // k-step pairs (32 of hd) summed from zero, then added in float32
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int p0 = 0; p0 < kKP; p0 += 2) {
      float part[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll
      for (int kp = p0; kp < p0 + 2; ++kp) {
        uint32_t ah[2][4], al[2][4];
        if constexpr (S::kQRegs) {
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ah[u][e] = qh[kp][u][e];
              al[u][e] = ql[kp][u][e];
            }
        } else {
          a_fragments(pair_at(qrow, qk_even, qk_odd, kp),
                      pair_at(qrow + 8 * HD, qk_even, qk_odd, kp), ah, al);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {  // keys key0 + 8j + g
          const float4 x = pair_at(ks + 8 * j * HD, qk_even, qk_odd, kp);
          uint32_t bh[2][2], bl[2][2];
          split_tf32_int(x.x, bh[0][0], bl[0][0]);
          split_tf32_int(x.y, bh[0][1], bl[0][1]);
          split_tf32_int(x.z, bh[1][0], bl[1][0]);
          split_tf32_int(x.w, bh[1][1], bl[1][1]);
          mma3(part[j], ah[0], al[0], bh[0], bl[0]);
          mma3(part[j], ah[1], al[1], bh[1], bl[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = p0 == 0 ? part[j][e] : s[j][e] + part[j][e];
    }

    // softcap and mask; s[j][e] is row q0 + row0 + g (+ 8 for e >= 2),
    // key k0 + key0 + 8j + 2t (+ 1 for odd e)
    const bool edge = k0 + kBK > kvl || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        if (edge) {
          const int qp = q0 + row0 + g + (e >> 1) * 8;
          const int kp = k0 + key0 + 8 * j + 2 * t + (e & 1);
          bool ok = kp < kvl;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && qp - kp < window;
          if (!ok) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], lsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
    }

    // P, split into the A fragments of P.V: k step j's keys 2t and 2t + 1
    // sit at A columns t and t + 4, so a = {c0, c2, c1, c3}
    uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f((s[j][e] - m[e >> 1]) * kLog2e);
        lsum[e >> 1] += p[e];
      }
      split_tf32_int(p[0], ph[j][0], pl[j][0]);
      split_tf32_int(p[2], ph[j][1], pl[j][1]);
      split_tf32_int(p[1], ph[j][2], pl[j][2]);
      split_tf32_int(p[3], ph[j][3], pl[j][3]);
    }

    l[0] = l[0] * alpha[0] + lsum[0];
    l[1] = l[1] * alpha[1] + lsum[1];

    // acc = acc * alpha + P.V, a fresh 3xTF32 partial per output slice:
    // slice 4G + u of column group G reads column 32G + 4g + u of V rows
    // 2t (b0) and 2t + 1 (b1) of each k step, one float4 per row
#pragma unroll
    for (int gr = 0; gr < kG; ++gr) {
      float part[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[u][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* vr = vs + v_base + 8 * j * HD + 32 * gr;
        const float4 x0 = *reinterpret_cast<const float4*>(vr);
        const float4 x1 = *reinterpret_cast<const float4*>(vr + HD);
        const float b0[4] = {x0.x, x0.y, x0.z, x0.w};
        const float b1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t bh[2], bl[2];
          split_tf32_int(b0[u], bh[0], bl[0]);
          split_tf32_int(b1[u], bh[1], bl[1]);
          mma3(part[u], ph[j], pl[j], bh, bl);
        }

      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float* a = acc[4 * gr + u];
        a[0] = fmaf(a[0], alpha[0], part[u][0]);
        a[1] = fmaf(a[1], alpha[0], part[u][1]);
        a[2] = fmaf(a[2], alpha[1], part[u][2]);
        a[3] = fmaf(a[3], alpha[1], part[u][3]);
      }
    }
  }

  if constexpr (S::kSplit == 2) {
    // the strip's second warp ran the online softmax over the other half
    // of every tile's keys: it hands (m, l, acc) over through the ring,
    // lane-major, and the first warp merges them
    constexpr int kWords = 4 + HD / 2;
    __syncthreads();  // every warp is done with the ring
    float* buf = ring + (warp & 3) * kWords * 32 + lane;
    if (warp >= 4) {
      buf[0] = m[0];
      buf[32] = m[1];
      buf[64] = l[0];
      buf[96] = l[1];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) buf[(4 + 4 * j + e) * 32] = acc[j][e];
    }
    __syncthreads();
    if (warp >= 4) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = buf[32 * r], mm = fmaxf(m[r], m1);
      a0[r] = exp2f((m[r] - mm) * kLog2e);
      a1[r] = exp2f((m1 - mm) * kLog2e);
      l[r] = l[r] * a0[r] + buf[64 + 32 * r] * a1[r];
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = acc[j][e] * a0[e >> 1] +
                    buf[(4 + 4 * j + e) * 32] * a1[e >> 1];
  }

  float* ob = o + (static_cast<size_t>(b) * Sq + q0) * q_row
            + static_cast<size_t>(h) * hd;
  // row g (+ 8): acc[4G + u][0] is column 32G + 8t + u, acc[4G + u][1]
  // column 32G + 8t + 4 + u
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    if (q0 + row >= Sq) continue;
    float* orow = ob + row * q_row;
#pragma unroll
    for (int gr = 0; gr < kG; ++gr)
#pragma unroll
      for (int h4 = 0; h4 < 2; ++h4) {
        const int d = 32 * gr + 8 * t + 4 * h4;
        float y[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) y[u] = acc[4 * gr + u][2 * r + h4] / denom;
        if constexpr (kVec) {
          if (d < hd)
            *reinterpret_cast<float4*>(orow + d) =
                make_float4(y[0], y[1], y[2], y[3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (d + u < hd) orow[d + u] = y[u];
        }
      }
  }
}

template <int HD, bool kVec>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int Sq, int Skv, int H, int K, int hd, int causal, int window,
           float softcap, int kv_len, float scale, cudaStream_t stream) {
  auto kernel = flash_attn_kernel<HD, kVec>;
  constexpr int smem = static_cast<int>(Shape<HD>::kSmem);
  static bool smem_set = false;  // per instance: raise the limit once
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, Shape<HD>::kThreads, smem, stream>>>(
      q, k, v, o, Sq, Skv, H, K, hd, causal, window, softcap, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(bool vec, const float* q, const float* k, const float* v,
           float* o, int B, int Sq, int Skv, int H, int K, int hd, int causal,
           int window, float softcap, int kv_len, float scale,
           cudaStream_t stream) {
  return vec ? launch<HD, true>(q, k, v, o, B, Sq, Skv, H, K, hd, causal,
                                window, softcap, kv_len, scale, stream)
             : launch<HD, false>(q, k, v, o, B, Sq, Skv, H, K, hd, causal,
                                 window, softcap, kv_len, scale, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// q, o (B, Sq, H, hd); k, v (B, Skv, K, hd): contiguous float32, H a
// multiple of K, 1 <= hd <= 256, B * H <= 65535; any Sq and Skv.  window
// <= 0 means no window, softcap <= 0 no softcap; keys at or beyond kv_len
// are masked.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int flash_attn_launch(const float* q, const float* k,
                                 const float* v, float* o, int B, int Sq,
                                 int Skv, int H, int K, int hd, int causal,
                                 int window, float softcap, int kv_len,
                                 float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || H % K != 0 || hd < 1 || hd > kMaxHeadDim || Skv <= 0 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = hd % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return launch<32>(vec, q, k, v, o, B, Sq, Skv, H, K, hd, causal, window,
                      softcap, kv_len, scale, s);
  if (hd <= 64)
    return launch<64>(vec, q, k, v, o, B, Sq, Skv, H, K, hd, causal, window,
                      softcap, kv_len, scale, s);
  if (hd <= 128)
    return launch<128>(vec, q, k, v, o, B, Sq, Skv, H, K, hd, causal, window,
                       softcap, kv_len, scale, s);
  return launch<256>(vec, q, k, v, o, B, Sq, Skv, H, K, hd, causal, window,
                     softcap, kv_len, scale, s);
}
