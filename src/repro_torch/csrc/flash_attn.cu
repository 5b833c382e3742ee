// Flash attention (online softmax, GQA-aware) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attn/kernel.py.  Same contract: q (B, Sq, H, hd),
// k and v (B, Skv, K, hd), float32, query head h reading KV head h / (H/K)
// (the query heads of one KV head are contiguous); scores are
// (q * scale) . k, optionally soft-capped (cap * tanh(s / cap)), masked
// with the finite NEG_INF = -1e30 where causal (q_pos < k_pos), outside a
// local window (q_pos - k_pos >= window) or on a padded key
// (k_pos >= kv_len); the running (m, l, acc) stay in float32 and the
// output is acc / max(l, 1e-30).  Sq and Skv arrive padded to the 64-row
// tiles; padded query rows are computed and sliced off by the wrapper.
//
// What bounds it on this card: operations.  Each live 64 x 64 tile pair is
// 2 * 64 * 64 * hd flops for the scores and as many for P @ V, against
// 2 * 64 * hd * 4 bytes of K and V, so from a few hundred keys on the
// work sits far above the 3.35 TB/s memory roof.  The products run in
// plain fp32 FMA (no TF32, no tensor cores), whose peak is ~67 TFLOP/s:
// the frontend's probes hold the kernel to 2e-4 of a float32 oracle at
// 8192 keys, which TF32's 10-bit mantissa would not keep.
//
// Design: one 256-thread block per (batch * query head, 64-row q tile),
// looping over 64-row KV tiles, as the TPU grid's sequential KV axis did.
// Q (pre-scaled), the K tile, the V tile and the probability tile P live
// in dynamic shared memory (216 KB at hd 256, hence the attribute set
// before every launch).  Thread (ty, tx) of a 16 x 16 grid owns query rows
// ty*4 .. ty*4+3: their scores against keys tx + 16j (j < 4), their
// running max and sum (reduced across the 16 lanes of the row group with
// xor shuffles, which leave every lane with the same bits), and their
// output columns tx + 16jj (jj < NJ = ceil(hd / 16)).  Q and K rows are
// read as float4s with a row stride chosen so that 8 consecutive rows hit
// 8 different bank groups.  KV tiles wholly in the causal future or wholly
// behind the window are never loaded; a row with no live key in a loaded
// tile takes p = 1 from NEG_INF - NEG_INF and a later live tile's
// alpha = exp(NEG_INF - m) = 0 wipes it, as on the TPU.  Causal grids run
// the heaviest q tiles first.

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per KV tile
constexpr int kThreads = 256;           // 16 x 16: 4 rows x 4 keys each
constexpr int kPStride = kBK + 4;       // P row stride (16-byte rows)
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

__host__ __device__ inline int padded_hd(int hd) { return (hd + 3) / 4 * 4; }

// Row stride of the Q and K tiles: a multiple of 4 floats whose quarter is
// odd, so the float4 reads of 8 consecutive rows are bank-conflict free.
__host__ __device__ inline int qk_stride(int hdp) {
  return hdp + ((hdp / 4) % 2 == 0 ? 4 : 8);
}

size_t smem_bytes(int hd) {
  const int hdp = padded_hd(hd), st = qk_stride(hdp);
  return sizeof(float) * (static_cast<size_t>(kBQ) * st
                          + static_cast<size_t>(kBK) * st
                          + static_cast<size_t>(kBK) * hdp
                          + static_cast<size_t>(kBQ) * kPStride);
}

// rows x hd floats (global row stride src_stride) -> shared rows of
// dst_stride, times mul, columns hd .. padded_hd(hd) zeroed.
__device__ inline void load_rows(float* dst, int dst_stride,
                                 const float* __restrict__ src,
                                 size_t src_stride, int rows, int hd,
                                 float mul) {
  if ((hd & 3) == 0) {
    const int n4 = hd / 4;
    for (int i = threadIdx.x; i < rows * n4; i += kThreads) {
      const int r = i / n4, c = (i % n4) * 4;
      float4 x = *reinterpret_cast<const float4*>(src + r * src_stride + c);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
      *reinterpret_cast<float4*>(dst + r * dst_stride + c) = x;
    }
  } else {
    const int hdp = padded_hd(hd);
    for (int i = threadIdx.x; i < rows * hdp; i += kThreads) {
      const int r = i / hdp, d = i % hdp;
      dst[r * dst_stride + d] = d < hd ? src[r * src_stride + d] * mul : 0.0f;
    }
  }
}

__device__ inline float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ inline float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq,
                  int Skv, int H, int K, int hd, int causal, int window,
                  float softcap, int kv_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hdp = padded_hd(hd), st = qk_stride(hdp);
  float* qs = smem;                     // [kBQ][st], q * scale
  float* ks = qs + kBQ * st;            // [kBK][st]
  float* vs = ks + kBK * st;            // [kBK][hdp]
  float* ps = vs + kBK * hdp;           // [kBQ][kPStride]

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / K);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_row = static_cast<size_t>(H) * hd;    // position stride
  const size_t kv_row = static_cast<size_t>(K) * hd;
  const float* qb = q + (static_cast<size_t>(b) * Sq + q0) * q_row
                  + static_cast<size_t>(h) * hd;
  const float* kb = k + static_cast<size_t>(b) * Skv * kv_row
                  + static_cast<size_t>(kvh) * hd;
  const float* vb = v + static_cast<size_t>(b) * Skv * kv_row
                  + static_cast<size_t>(kvh) * hd;
  float* ob = o + (static_cast<size_t>(b) * Sq + q0) * q_row
            + static_cast<size_t>(h) * hd;

  load_rows(qs, st, qb, q_row, kBQ, hd, scale);

  // live KV tiles: none wholly in the causal future, none wholly behind
  // the window of the block's first query
  int kt_lo = 0, kt_hi = Skv / kBK;
  if (causal) kt_hi = min(kt_hi, (q0 + kBQ - 1) / kBK + 1);
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / kBK;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.0f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                    // last tile's readers are done
    load_rows(ks, st, kb + k0 * kv_row, kv_row, kBK, hd, 1.0f);
    load_rows(vs, hdp, vb + k0 * kv_row, kv_row, kBK, hd, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hdp; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * st + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * st + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool ok = kp < kv_len;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && (qp - kp) < window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        ps[(ty * 4 + i) * kPStride + tx + 16 * j] = s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kPStride
                                                + c);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tx + 16 * jj;
        if (d < hd) {
          const float v0 = vs[(c + 0) * hdp + d];
          const float v1 = vs[(c + 1) * hdp + d];
          const float v2 = vs[(c + 2) * hdp + d];
          const float v3 = vs[(c + 3) * hdp + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a = acc[i][jj];
            a = fmaf(p[i].x, v0, a);
            a = fmaf(p[i].y, v1, a);
            a = fmaf(p[i].z, v2, a);
            a = fmaf(p[i].w, v3, a);
            acc[i][jj] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = ob + (ty * 4 + i) * q_row;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < hd) orow[d] = acc[i][jj] / denom;
    }
  }
}

template <int NJ>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int Sq, int Skv, int H, int K, int hd, int causal, int window,
           float softcap, int kv_len, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Sq / kBQ, B * H);
  flash_attn_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, Sq, Skv, H, K, hd, causal, window, softcap, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o (B, Sq, H, hd); k, v (B, Skv, K, hd): contiguous float32, 16-byte
// aligned, Sq and Skv multiples of 64, H a multiple of K, 1 <= hd <= 256.
// window <= 0 means no window, softcap <= 0 no softcap; keys at or beyond
// kv_len are masked.  Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int flash_attn_launch(const float* q, const float* k,
                                 const float* v, float* o, int B, int Sq,
                                 int Skv, int H, int K, int hd, int causal,
                                 int window, float softcap, int kv_len,
                                 float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || H % K != 0 || hd < 1 || hd > kMaxHeadDim || Skv <= 0
      || Sq % kBQ != 0 || Skv % kBK != 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 16)
    return launch<1>(q, k, v, o, B, Sq, Skv, H, K, hd, causal, window,
                     softcap, kv_len, scale, s);
  if (hd <= 32)
    return launch<2>(q, k, v, o, B, Sq, Skv, H, K, hd, causal, window,
                     softcap, kv_len, scale, s);
  if (hd <= 64)
    return launch<4>(q, k, v, o, B, Sq, Skv, H, K, hd, causal, window,
                     softcap, kv_len, scale, s);
  if (hd <= 128)
    return launch<8>(q, k, v, o, B, Sq, Skv, H, K, hd, causal, window,
                     softcap, kv_len, scale, s);
  return launch<16>(q, k, v, o, B, Sq, Skv, H, K, hd, causal, window,
                    softcap, kv_len, scale, s);
}
