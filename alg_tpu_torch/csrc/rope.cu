// Interleaved-pair RoPE over [B, H, S, D]: out = x·cos + rot(x)·sin with
// rot(x0, x1) = (-x1, x0) on each adjacent pair.
//
// Replaces the TPU kernel alg_tpu/ops/qk_prep.py:_rope_kernel (Wan's q and
// k: the RMS norm there runs over the full inner dim before the head split,
// so only the rotation is left to fuse). One thread owns 16 bytes of a row:
// eight bf16 or four fp32 values, that is four or two whole pairs, so the
// rotation needs no shuffle. The fp32 tables [S, D] are rounded to the
// activation type before use, as the reference casts them; the rotation
// runs in fp32 and rounds once on store.
//
// The input is read through its strides (unit stride along D): the models
// hand over the [B, S, H, D] projection viewed as [B, H, S, D], and reading
// that view directly saves the separate transposing copy. The output is
// written contiguous, in order, one 16-byte store per thread.
//
// Bound on the H100: bytes. One read and one write of x (2 x 629 MB at the
// [3,40,32760,128] bf16 shape) plus the fp32 cos/sin rows, which are shared
// by all B·H heads and stay in L2. Any S >= 1; D a multiple of 8.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, long long stride_b, long long stride_h, long long stride_s,
            const float* __restrict__ cos_t, const float* __restrict__ sin_t,
            T* __restrict__ out, int heads, int seq, int head_dim) {
  constexpr int kVec = alg::Vec16<T>::N;
  // blockIdx.y is the head b·H + h; blockIdx.x walks that head's S·D/kVec
  // vectors, so the per-thread index arithmetic stays in 32 bits
  const int vecs_per_row = head_dim / kVec;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= seq * vecs_per_row) return;
  const int s = i / vecs_per_row;
  const int c = (i - s * vecs_per_row) * kVec;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;

  float xv[kVec], cs[kVec], sn[kVec], o[kVec];
  alg::Vec16<T>::load(x + b * stride_b + h * stride_h + s * stride_s + c, xv);
  const float* cp = cos_t + s * head_dim + c;
  const float* sp = sin_t + s * head_dim + c;
#pragma unroll
  for (int e = 0; e < kVec; e += 4) {
    alg::load4(cp + e, cs + e);
    alg::load4(sp + e, sn + e);
  }
#pragma unroll
  for (int e = 0; e < kVec; e += 2) {
    const float c0 = alg::round_to<T>(cs[e]), c1 = alg::round_to<T>(cs[e + 1]);
    const float s0 = alg::round_to<T>(sn[e]), s1 = alg::round_to<T>(sn[e + 1]);
    o[e] = xv[e] * c0 - xv[e + 1] * s0;
    o[e + 1] = xv[e + 1] * c1 + xv[e] * s1;
  }
  T* op = out + ((long long)bh * seq + s) * head_dim + c;
#pragma unroll
  for (int e = 0; e < kVec; e += 4) alg::store4(op + e, o[e], o[e + 1], o[e + 2], o[e + 3]);
}

template <typename T>
cudaError_t launch(const void* x, long long stride_b, long long stride_h, long long stride_s,
                   const void* cos_t, const void* sin_t, void* out, long long rows, int heads,
                   int seq, int head_dim, cudaStream_t stream) {
  constexpr int kVec = alg::Vec16<T>::N;
  if (head_dim % kVec != 0 || stride_b % kVec != 0 || stride_h % kVec != 0 || stride_s % kVec != 0)
    return cudaErrorInvalidValue;
  const long long vecs_per_head = (long long)seq * (head_dim / kVec);
  const long long bh = rows / seq;
  if (vecs_per_head > 0x7fffffffLL - kThreads || bh > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((vecs_per_head + kThreads - 1) / kThreads), (unsigned)bh);
  rope_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), stride_b, stride_h, stride_s, static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(out), heads, seq, head_dim);
  return cudaGetLastError();
}

}  // namespace

// x: [B, H, S, D] of `dtype` with element (b, h, s, d) at
// b·stride_b + h·stride_h + s·stride_s + d (strides in elements, multiples
// of 16 bytes); out: the same shape, contiguous; cos/sin: [S, D] fp32,
// contiguous. rows = B·H·S, with B·H <= 65535 and S·D < 2^31. Returns the
// launch's cudaError_t (0 on success).
extern "C" int alg_rope_interleaved(int dtype, const void* x, long long stride_b,
                                    long long stride_h, long long stride_s, const void* cos_t,
                                    const void* sin_t, void* out, long long rows, int heads,
                                    int seq, int head_dim, void* stream) {
  if (rows <= 0 || heads <= 0 || seq <= 0 || head_dim <= 0 || rows % ((long long)heads * seq) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case alg::kFloat32:
      return (int)launch<float>(x, stride_b, stride_h, stride_s, cos_t, sin_t, out, rows, heads,
                                seq, head_dim, st);
    case alg::kBFloat16:
      return (int)launch<__nv_bfloat16>(x, stride_b, stride_h, stride_s, cos_t, sin_t, out, rows,
                                        heads, seq, head_dim, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
