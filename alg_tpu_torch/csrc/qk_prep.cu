// Fused per-head LayerNorm + interleaved RoPE over [B, H, S, 64].
//
// Replaces the TPU kernel alg_tpu/ops/qk_prep.py:_kernel. Statistics are fp32
// (two passes, like the reference: the mean, then the mean of squared
// deviations), the affine is fp32, and the normalised value is rounded to the
// activation type, as the reference's layer_norm casts back before the
// rotation; the rotation runs in fp32 and rounds once on store.
//
// Bound on the H100: bytes. One read and one write of x (2 x 437 MB at the
// [2,48,17776,64] bf16 shape) plus one read of the fp32 cos/sin tables
// (9.1 MB at S = 17,776).
//
// Design (as csrc/rope.cu). The tables are shared by all B·H heads; a grid
// that walks every table row once per head reads them B·H times (96 x 9.1 MB
// at the shape above, twice the bytes of x, mostly from L2). Here a block
// takes one tile of S and one chunk of at most kMaxChunk heads, and the
// chunks of a tile are neighbouring blocks of the grid, so the tile's table
// rows cross from device memory once a launch. A thread owns 16 bytes of one
// row s (eight bf16 or four fp32 values: whole pairs, so the rotation needs
// no shuffle): it reads that slot of the tables (rounded to T) and of the
// affine once and keeps them in registers, then walks the heads of its
// chunk, kHeadsInFlight at a time (their 16-byte loads all issued before the
// first is used), writing each head's slot with one 16-byte store. The row's
// statistics are sums over the lanes that share the row (8 lanes in bf16, 16
// in fp32, aligned groups of the warp) by xor shuffles inside the group.
//
// The input is read through its strides (unit stride along D): the DiT hands
// over the [B, S, H, D] projection viewed as [B, H, S, D], and reading that
// view directly saves the separate transposing copy. The output is written
// contiguous. Any S >= 1.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 256;
constexpr int kMaxChunk = 8;       // heads a block walks, at most
constexpr int kHeadsInFlight = 4;  // loads a thread issues before it uses the first

// Sum over the kLanes lanes of an aligned group (all lanes of the warp take part).
template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qk_prep_kernel(const T* __restrict__ x, long long stride_b, long long stride_h, long long stride_s,
               const float* __restrict__ scale, const float* __restrict__ bias, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, T* __restrict__ out, int heads, int n_heads, int n_chunks,
               int chunk, int seq, float eps) {
  using V = alg::Vec16<T>;
  constexpr int kVec = V::N;
  constexpr int kLanes = kHeadDim / kVec;  // lanes that share a row
  static_assert(kThreads % kLanes == 0 && 32 % kLanes == 0, "a row's lanes lie in one warp");
  // block (S tile, chunk), chunks fastest; a tile covers kThreads of the S·64/kVec slots of a head
  const int s_tile = blockIdx.x / n_chunks, first = (blockIdx.x - s_tile * n_chunks) * chunk;
  const int i = s_tile * kThreads + threadIdx.x;
  // the tile's last rows may lie past S: those lanes (whole groups) take part in the shuffles and store nothing
  const bool active = i < seq * kLanes;
  const int s = active ? i / kLanes : 0;
  const int c = (i % kLanes) * kVec;

  // this slot of the tables (rounded to T) and of the affine, for every head of the chunk
  float cs[kVec], sn[kVec], g[kVec], bb[kVec];
#pragma unroll
  for (int e = 0; e < kVec; e += 4) {
    alg::load4(cos_t + s * kHeadDim + c + e, cs + e);
    alg::load4(sin_t + s * kHeadDim + c + e, sn + e);
    alg::load4(scale + c + e, g + e);
    alg::load4(bias + c + e, bb + e);
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    cs[e] = alg::round_to<T>(cs[e]);
    sn[e] = alg::round_to<T>(sn[e]);
  }

  const long long x_at = s * stride_s + c;                     // the slot in head (0, 0) of x
  T* const o_at = out + (long long)s * kHeadDim + c;           // and of out, whose heads are S·64 apart
  const long long o_head = (long long)seq * kHeadDim;
  const int bh_end = min(n_heads, first + chunk);
  for (int bh = first; bh < bh_end; bh += kHeadsInFlight) {
    uint4 raw[kHeadsInFlight];
#pragma unroll
    for (int u = 0; u < kHeadsInFlight; ++u) {
      if (active && bh + u < bh_end) {
        const int b = (bh + u) / heads, h = (bh + u) - b * heads;
        raw[u] = *reinterpret_cast<const uint4*>(x + b * stride_b + h * stride_h + x_at);
      } else {
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kHeadsInFlight; ++u) {
      if (bh + u < bh_end) {  // the same for every thread of the block
        float xv[kVec], o[kVec];
        V::unpack(raw[u], xv);
        float sum = 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) sum += xv[e];
        const float mean = group_sum<kLanes>(sum) * (1.0f / kHeadDim);
        float sq = 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          xv[e] -= mean;
          sq += xv[e] * xv[e];
        }
        const float r = rsqrtf(group_sum<kLanes>(sq) * (1.0f / kHeadDim) + eps);
#pragma unroll
        for (int e = 0; e < kVec; ++e) xv[e] = alg::round_to<T>(xv[e] * r * g[e] + bb[e]);
#pragma unroll
        for (int e = 0; e < kVec; e += 2) {
          o[e] = xv[e] * cs[e] - xv[e + 1] * sn[e];
          o[e + 1] = xv[e + 1] * cs[e + 1] + xv[e] * sn[e + 1];
        }
        if (active) V::store(o_at + (bh + u) * o_head, o);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, long long stride_b, long long stride_h, long long stride_s, const void* scale,
                   const void* bias, const void* cos_t, const void* sin_t, void* out, long long n_heads, int heads,
                   int seq, float eps, cudaStream_t stream) {
  constexpr int kVec = alg::Vec16<T>::N;
  if (stride_b % kVec != 0 || stride_h % kVec != 0 || stride_s % kVec != 0) return cudaErrorInvalidValue;
  const long long vecs_per_head = (long long)seq * (kHeadDim / kVec);
  if (vecs_per_head > 0x7fffffffLL - kThreads || n_heads > 0x7fffffffLL - kHeadsInFlight)
    return cudaErrorInvalidValue;
  const long long s_tiles = (vecs_per_head + kThreads - 1) / kThreads;
  // the heads in as few chunks of at most kMaxChunk as there can be, all but the last of one size
  const long long n_chunks = (n_heads + kMaxChunk - 1) / kMaxChunk;
  const long long chunk = (n_heads + n_chunks - 1) / n_chunks;
  if (s_tiles * n_chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  qk_prep_kernel<T><<<(unsigned)(s_tiles * n_chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), stride_b, stride_h, stride_s, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<T*>(out), heads, (int)n_heads, (int)n_chunks, (int)chunk, seq, eps);
  return cudaGetLastError();
}

}  // namespace

// x: [B, H, S, 64] of `dtype` with element (b, h, s, d) at
// b·stride_b + h·stride_h + s·stride_s + d (strides in elements, multiples
// of 16 bytes); out: the same shape, contiguous; scale/bias: [64] fp32;
// cos/sin: [S, 64] fp32, contiguous; all 16-byte aligned. rows = B·H·S, with
// B·H, S·64 < 2^31 - 256. Returns the launch's cudaError_t (0 on success).
extern "C" int alg_qk_prep(int dtype, const void* x, long long stride_b, long long stride_h, long long stride_s,
                           const void* scale, const void* bias, const void* cos_t, const void* sin_t, void* out,
                           long long rows, int heads, int seq, int head_dim, float eps, void* stream) {
  if (head_dim != kHeadDim || rows <= 0 || heads <= 0 || seq <= 0 || rows % ((long long)heads * seq) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_heads = rows / seq;
  switch (dtype) {
    case alg::kFloat32:
      return (int)launch<float>(x, stride_b, stride_h, stride_s, scale, bias, cos_t, sin_t, out, n_heads, heads,
                                seq, eps, st);
    case alg::kBFloat16:
      return (int)launch<__nv_bfloat16>(x, stride_b, stride_h, stride_s, scale, bias, cos_t, sin_t, out, n_heads,
                                        heads, seq, eps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
