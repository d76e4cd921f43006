// Fused per-head LayerNorm + interleaved RoPE over [B, H, S, 64].
//
// Replaces the TPU kernel alg_tpu/ops/qk_prep.py:_kernel. One warp owns one
// (b·h, s) row of 64 values; lane l holds the pair (2l, 2l+1), so the RoPE
// rotation (y0, y1) -> (-y1, y0) needs no shuffle. Statistics are fp32 warp
// reductions (two passes, like the reference: mean, then mean of squared
// deviations). The normalised value is rounded to the activation type, as
// the reference's layer_norm casts back before the rotation; the rotation
// runs in fp32 and rounds once on store.
//
// Bound on the H100: bytes. One read and one write of x (2 x 437 MB at the
// [2,48,17776,64] bf16 shape) plus the fp32 cos/sin rows, which stay in L2.
// Left for later: 16-byte accesses (a lane moves 4 or 8 bytes here) and
// several rows per warp to cut the per-row reduction cost.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kRowsPerBlock = 8;  // 8 warps, 256 threads

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
qk_prep_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, T* __restrict__ out, long long rows,
               int seq, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps exit together
  const int s = (int)(row % seq);
  const int c = 2 * lane;

  const float2 xv = alg::load2(x + row * kHeadDim + c);
  const float mean = warp_sum(xv.x + xv.y) * (1.0f / kHeadDim);
  const float d0 = xv.x - mean, d1 = xv.y - mean;
  const float var = warp_sum(d0 * d0 + d1 * d1) * (1.0f / kHeadDim);
  const float r = rsqrtf(var + eps);
  const float2 g = *reinterpret_cast<const float2*>(scale + c);
  const float2 b = *reinterpret_cast<const float2*>(bias + c);
  const float y0 = alg::round_to<T>(d0 * r * g.x + b.x);
  const float y1 = alg::round_to<T>(d1 * r * g.y + b.y);

  const float2 cs = *reinterpret_cast<const float2*>(cos_t + (long long)s * kHeadDim + c);
  const float2 sn = *reinterpret_cast<const float2*>(sin_t + (long long)s * kHeadDim + c);
  const float c0 = alg::round_to<T>(cs.x), c1 = alg::round_to<T>(cs.y);
  const float s0 = alg::round_to<T>(sn.x), s1 = alg::round_to<T>(sn.y);
  alg::store2(out + row * kHeadDim + c, y0 * c0 - y1 * s0, y1 * c1 + y0 * s1);
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias, const void* cos_t,
                   const void* sin_t, void* out, long long rows, int seq, float eps,
                   cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  qk_prep_kernel<T><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(out), rows, seq, eps);
  return cudaGetLastError();
}

}  // namespace

// x/out: [rows, 64] of `dtype` (rows = B·H·S, row r at sequence position
// r % seq); scale/bias: [64] fp32; cos/sin: [seq, 64] fp32. Returns the
// launch's cudaError_t (0 on success).
extern "C" int alg_qk_prep(int dtype, const void* x, const void* scale, const void* bias,
                           const void* cos_t, const void* sin_t, void* out, long long rows,
                           int seq, int head_dim, float eps, void* stream) {
  if (head_dim != kHeadDim || rows <= 0 || seq <= 0 || rows % seq != 0 ||
      (rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case alg::kFloat32:
      return (int)launch<float>(x, scale, bias, cos_t, sin_t, out, rows, seq, eps, st);
    case alg::kBFloat16:
      return (int)launch<__nv_bfloat16>(x, scale, bias, cos_t, sin_t, out, rows, seq, eps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
