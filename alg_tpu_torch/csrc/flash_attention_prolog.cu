// Flash-attention forward with the in-kernel qk prolog (per-head LayerNorm or
// RMS norm, then interleaved RoPE, on the q rows and on every K tile): the
// kernels and C entry points over the body in flash_attention.cuh, which says
// what is computed and how. Replaces the prolog variant of the TPU kernel
// alg_tpu/ops/flash_attention.py:_fwd_kernel (its qk_norm, rope_cos / rope_sin
// and prolog_k). A compile unit of its own, so that a call without a prolog
// launches code that this file cannot change. The build reads the next line
// and makes one object per head dim, each with its own C entry point.
//
// build-variants: ALG_FLASH_HEAD_DIM=64,80,128
#include "flash_attention.cuh"

namespace {

template <typename T, bool kStable, bool kBias>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_prolog_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ bias, long long bias_b_stride,
                        const int* __restrict__ kv_len, T* __restrict__ out, float* __restrict__ lse,
                        int heads, int sq, int sk, int causal_offset, float scale_log2, const Prolog pro) {
  flash_fwd_body<T, kStable, kBias, true>(q, k, v, bias, bias_b_stride, kv_len, out, lse, heads, sq, sk,
                                          causal_offset, scale_log2, pro);
}

template <typename T, bool kStable, bool kBias>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   long long bias_b_stride, const void* kv_len, void* out, void* lse, int batch,
                   int heads, int sq, int sk, int causal_offset, float scale, const Prolog& pro,
                   cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_prolog_kernel<T, kStable, kBias><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), bias_b_stride, static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(lse), heads, sq, sk, causal_offset, scale * kLog2e, pro);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* bias,
                     long long bias_b_stride, const void* kv_len, void* out, void* lse, int batch,
                     int heads, int sq, int sk, int causal_offset, float scale, bool stable,
                     const Prolog& pro, cudaStream_t st) {
  if (bias != nullptr) {
    return stable ? launch<T, true, true>(q, k, v, bias, bias_b_stride, kv_len, out, lse, batch, heads, sq, sk, causal_offset, scale, pro, st)
                  : launch<T, false, true>(q, k, v, bias, bias_b_stride, kv_len, out, lse, batch, heads, sq, sk, causal_offset, scale, pro, st);
  }
  return stable ? launch<T, true, false>(q, k, v, bias, 0, kv_len, out, lse, batch, heads, sq, sk, causal_offset, scale, pro, st)
                : launch<T, false, false>(q, k, v, bias, 0, kv_len, out, lse, batch, heads, sq, sk, causal_offset, scale, pro, st);
}

}  // namespace

// alg_flash_attention_prolog_fwd_d<D>: alg_flash_attention_fwd_d<D>'s arguments
// (flash_attention.cu), then the prolog's: norm (0 none, 1 LayerNorm, 2 RMS
// norm), eps, the fp32 [D] affines q_scale, q_bias, k_scale, k_bias (the
// biases read by LayerNorm only, the k ones only with prolog_k), the fp32
// [S, D] RoPE tables cos and sin (both null: no RoPE; else Sq == Sk), and
// prolog_k (0: q alone is transformed). Returns the launch's cudaError_t.
extern "C" int ALG_CAT(alg_flash_attention_prolog_fwd_d, ALG_FLASH_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    long long bias_b_stride, const void* kv_len, void* out, void* lse, int batch, int heads, int sq,
    int sk, float scale, int stable, int causal, int norm, float eps, const void* q_scale,
    const void* q_bias, const void* k_scale, const void* k_bias, const void* cos_t, const void* sin_t,
    int prolog_k, void* stream) {
  const bool rope = cos_t != nullptr;
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || (long long)batch * heads > 65535 || norm < 0 ||
      norm > kNormRms || rope != (sin_t != nullptr) || (rope && sq != sk) || (norm == 0 && !rope) ||
      (norm != 0 && (q_scale == nullptr || (prolog_k != 0 && k_scale == nullptr))) ||
      (norm == kNormLayer && (q_bias == nullptr || (prolog_k != 0 && k_bias == nullptr))))
    return (int)cudaErrorInvalidValue;
  const Prolog pro{norm, eps, static_cast<const float*>(q_scale), static_cast<const float*>(q_bias),
                   static_cast<const float*>(k_scale), static_cast<const float*>(k_bias),
                   static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), prolog_k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int causal_offset = causal != 0 ? sk - sq : kNotCausal;
  switch (dtype) {
    case alg::kFloat32:
      return (int)dispatch<float>(q, k, v, bias, bias_b_stride, kv_len, out, lse, batch, heads, sq,
                                  sk, causal_offset, scale, stable != 0, pro, st);
    case alg::kBFloat16:
      return (int)dispatch<__nv_bfloat16>(q, k, v, bias, bias_b_stride, kv_len, out, lse, batch,
                                          heads, sq, sk, causal_offset, scale, stable != 0, pro, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
