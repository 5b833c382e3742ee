// Fused sigma-delta encoder for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sigma_delta_kernel` / `sigma_delta_pallas` in
// src/repro/kernels/sigma_delta/kernel.py.  Elementwise, in float32:
//
//     delta = a - s
//     q     = rint(delta / theta) * theta   where |delta| >= theta, else 0
//     s'    = s + q
//
// q is written in a's type and s' in s's type (one type for both here:
// float32 or bfloat16).  In bfloat16, s' is the float32 sum s + q rounded
// once, not s plus the rounded q, as the TPU kernel computes it.
//
// What bounds it on this card: bytes.  Four arrays are moved once (a and s
// read, q and s' written) for about six operations per element, far below
// the card's balance point.
//
// Design: a grid-stride loop over 16-byte vectors (a float4, or four
// bf16x2 pairs), so every load and store is one 16-byte access per
// thread, with a scalar tail.  The arithmetic must give the bits of the
// plain version: rint (round half to even, as torch.round and jnp.round),
// an IEEE division (not a multiply by 1/theta), and explicitly rounded
// multiply and add (__fmul_rn / __fadd_rn), which the compiler never
// contracts into an FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;    // 16 blocks per SM of an H100

__device__ __forceinline__ void encode(float a, float s, float theta,
                                       float& q, float& s_new) {
  const float delta = __fsub_rn(a, s);
  q = fabsf(delta) >= theta ? __fmul_rn(rintf(__fdiv_rn(delta, theta)), theta)
                            : 0.0f;
  s_new = __fadd_rn(s, q);
}

__global__ void __launch_bounds__(kThreads)
sigma_delta_f32(const float* __restrict__ a, const float* __restrict__ s,
                float* __restrict__ q, float* __restrict__ s_out,
                long long n, float theta) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
  const long long n4 = n / 4;
  for (long long i = first; i < n4; i += stride) {
    const float4 av = reinterpret_cast<const float4*>(a)[i];
    const float4 sv = reinterpret_cast<const float4*>(s)[i];
    float4 qv, ov;
    encode(av.x, sv.x, theta, qv.x, ov.x);
    encode(av.y, sv.y, theta, qv.y, ov.y);
    encode(av.z, sv.z, theta, qv.z, ov.z);
    encode(av.w, sv.w, theta, qv.w, ov.w);
    reinterpret_cast<float4*>(q)[i] = qv;
    reinterpret_cast<float4*>(s_out)[i] = ov;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride)
    encode(a[i], s[i], theta, q[i], s_out[i]);
}

__global__ void __launch_bounds__(kThreads)
sigma_delta_bf16(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ s,
                 __nv_bfloat16* __restrict__ q,
                 __nv_bfloat16* __restrict__ s_out, long long n,
                 float theta) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
  const long long n8 = n / 8;
  for (long long i = first; i < n8; i += stride) {
    const uint4 araw = reinterpret_cast<const uint4*>(a)[i];
    const uint4 sraw = reinterpret_cast<const uint4*>(s)[i];
    const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&araw);
    const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(&sraw);
    uint4 qraw, oraw;
    __nv_bfloat162* qp = reinterpret_cast<__nv_bfloat162*>(&qraw);
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&oraw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 af = __bfloat1622float2(ap[j]);
      const float2 sf = __bfloat1622float2(sp[j]);
      float2 qf, of;
      encode(af.x, sf.x, theta, qf.x, of.x);
      encode(af.y, sf.y, theta, qf.y, of.y);
      qp[j] = __floats2bfloat162_rn(qf.x, qf.y);
      op[j] = __floats2bfloat162_rn(of.x, of.y);
    }
    reinterpret_cast<uint4*>(q)[i] = qraw;
    reinterpret_cast<uint4*>(s_out)[i] = oraw;
  }
  for (long long i = 8 * n8 + first; i < n; i += stride) {
    float qf, of;
    encode(__bfloat162float(a[i]), __bfloat162float(s[i]), theta, qf, of);
    q[i] = __float2bfloat16_rn(qf);
    s_out[i] = __float2bfloat16_rn(of);
  }
}

}  // namespace

// a, s, q, s_out: n contiguous elements, float32 (bf16 == 0) or bfloat16
// (bf16 == 1), 16-byte aligned.  theta > 0.  Launches on `stream` and
// returns the launch's cudaError_t.
extern "C" int sigma_delta_launch(const void* a, const void* s, void* q,
                                  void* s_out, long long n, float theta,
                                  int bf16, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long per_block = static_cast<long long>(kThreads) * (bf16 ? 8 : 4);
  const long long want = (n + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    sigma_delta_bf16<<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(q),
        static_cast<__nv_bfloat16*>(s_out), n, theta);
  } else {
    sigma_delta_f32<<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(s),
        static_cast<float*>(q), static_cast<float*>(s_out), n, theta);
  }
  return static_cast<int>(cudaGetLastError());
}
