// Flash-attention forward over [B, H, S, 64], online softmax in base 2.
//
// Replaces the TPU kernel alg_tpu/ops/flash_attention.py:_fwd_kernel in the
// variants the CogVideoX main path runs: dense, `stable` true (running max)
// or false (bounded logits, no max), and an optional additive fp32 bias
// [1|B, H, Sq, Sk] (T5's relative-position bias). Logits are
// (q.k)·scale·log2e + bias·log2e and p = exp2(logit [- running max]).
//
// Design. One thread block per (b·h, tile of 128 queries); each thread owns
// one query row and keeps its q row, the fp32 accumulator, the running
// denominator and (stable) the running max in registers. The block walks the
// key sequence in tiles of 64 keys staged in shared memory as fp32 (the loop
// that takes the place of the TPU grid's sequential "arbitrary" axis), and
// inside a tile in chunks of 16 keys: 16 logits, their exponentials, then
// the P·V update. Every thread reads the same K/V element at a time, so the
// shared-memory reads are broadcasts. Keys past Sk are zero-filled in shared
// memory and masked to -inf, so they add nothing to numerator or
// denominator; chunks that start past Sk are skipped. Query rows past Sq
// compute on zeros and are not written. No host-side padding.
//
// Bound on the H100: tensor-core FLOPs (4·B·H·Sq·Sk·64 per call, 7.8 TFLOP
// at [2,48,17776,64]). This first version runs on the CUDA cores in fp32
// FMAs for both bf16 and fp32 inputs, so it sits far below the tensor-core
// roof; mma/wgmma tiles, TMA staging and warp specialisation are later work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBlockQ = 128;  // query rows per block = threads per block
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;    // keys per logits/exp/P·V round
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, bool kStable, bool kBias>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, long long bias_b_stride, T* __restrict__ out,
                 int heads, int sq, int sk, float scale_log2) {
  __shared__ __align__(16) float ks[kBlockK][kD];
  __shared__ __align__(16) float vs[kBlockK][kD];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool valid_row = row < sq;
  const T* kp = k + (long long)bh * sk * kD;
  const T* vp = v + (long long)bh * sk * kD;

  float qr[kD];
  if (valid_row) {
    const T* qrow = q + ((long long)bh * sq + row) * kD;
#pragma unroll
    for (int d = 0; d < kD; d += alg::Vec16<T>::N) alg::Vec16<T>::load(qrow + d, qr + d);
  } else {
#pragma unroll
    for (int d = 0; d < kD; ++d) qr[d] = 0.0f;
  }
  const float* brow = nullptr;
  if (kBias && valid_row) {
    const int b = bh / heads, h = bh % heads;
    brow = bias + b * bias_b_stride + ((long long)h * sq + row) * sk;
  }

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.0f;
  float m = -INFINITY;  // running max (stable only)
  float l = 0.0f;       // running denominator

  constexpr int kVec = alg::Vec16<T>::N;
  constexpr int kVecsPerTile = kBlockK * kD / kVec;
  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < kVecsPerTile; i += kBlockQ) {
      const int r = i * kVec / kD, c = i * kVec % kD;
      float kb[kVec], vb[kVec];
      if (k0 + r < sk) {
        alg::Vec16<T>::load(kp + (long long)(k0 + r) * kD + c, kb);
        alg::Vec16<T>::load(vp + (long long)(k0 + r) * kD + c, vb);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kb[e] = vb[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(&ks[r][c + e]) = make_float4(kb[e], kb[e + 1], kb[e + 2], kb[e + 3]);
        *reinterpret_cast<float4*>(&vs[r][c + e]) = make_float4(vb[e], vb[e + 1], vb[e + 2], vb[e + 3]);
      }
    }
    __syncthreads();

    const int kn = min(kBlockK, sk - k0);
    for (int j0 = 0; j0 < kn; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) s[jj] = 0.0f;
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 kv = *reinterpret_cast<const float4*>(&ks[j0 + jj][d]);
          s[jj] = fmaf(qr[d], kv.x, s[jj]);
          s[jj] = fmaf(qr[d + 1], kv.y, s[jj]);
          s[jj] = fmaf(qr[d + 2], kv.z, s[jj]);
          s[jj] = fmaf(qr[d + 3], kv.w, s[jj]);
        }
      }
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int key = k0 + j0 + jj;
        float t = s[jj] * scale_log2;
        if (kBias && valid_row && key < sk) t += brow[key] * kLog2e;
        s[jj] = key < sk ? t : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      if (kStable) {
        // the chunk holds at least one valid key, so cmax and m_new are finite
        const float m_new = fmaxf(m, cmax);
        const float alpha = exp2f(m - m_new);  // 0 on the first chunk (m = -inf)
        l *= alpha;
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[d] *= alpha;
        m = m_new;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = exp2f(kStable ? s[jj] - m : s[jj]);
        l += s[jj];
      }
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j0 + jj][d]);
          acc[d] = fmaf(s[jj], vv.x, acc[d]);
          acc[d + 1] = fmaf(s[jj], vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[jj], vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[jj], vv.w, acc[d + 3]);
        }
      }
    }
  }

  if (!valid_row) return;
  const float inv = 1.0f / (l == 0.0f ? 1.0f : l);
  T* orow = out + ((long long)bh * sq + row) * kD;
#pragma unroll
  for (int d = 0; d < kD; d += 2) alg::store2(orow + d, acc[d] * inv, acc[d + 1] * inv);
}

template <typename T, bool kStable, bool kBias>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   long long bias_b_stride, void* out, int batch, int heads, int sq, int sk,
                   float scale, cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<T, kStable, kBias><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), bias_b_stride, static_cast<T*>(out), heads, sq, sk,
      scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* bias,
                     long long bias_b_stride, void* out, int batch, int heads, int sq, int sk,
                     float scale, bool stable, cudaStream_t st) {
  if (bias != nullptr) {
    return stable ? launch<T, true, true>(q, k, v, bias, bias_b_stride, out, batch, heads, sq, sk, scale, st)
                  : launch<T, false, true>(q, k, v, bias, bias_b_stride, out, batch, heads, sq, sk, scale, st);
  }
  return stable ? launch<T, true, false>(q, k, v, bias, 0, out, batch, heads, sq, sk, scale, st)
                : launch<T, false, false>(q, k, v, bias, 0, out, batch, heads, sq, sk, scale, st);
}

}  // namespace

// q/out: [B, H, Sq, 64], k/v: [B, H, Sk, 64], contiguous, of `dtype`.
// bias: null, or fp32 with element (b, h, i, j) at
// b·bias_b_stride + (h·Sq + i)·Sk + j (bias_b_stride 0 broadcasts one
// [H, Sq, Sk] bias over the batch). Returns the launch's cudaError_t.
extern "C" int alg_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                       const void* bias, long long bias_b_stride, void* out,
                                       int batch, int heads, int sq, int sk, int head_dim,
                                       float scale, int stable, void* stream) {
  if (head_dim != kD || batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case alg::kFloat32:
      return (int)dispatch<float>(q, k, v, bias, bias_b_stride, out, batch, heads, sq, sk, scale,
                                  stable != 0, st);
    case alg::kBFloat16:
      return (int)dispatch<__nv_bfloat16>(q, k, v, bias, bias_b_stride, out, batch, heads, sq, sk,
                                          scale, stable != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
