// Flash-attention forward, the fp32 calls without a qk prolog: the kernels
// and C entry points over the body in flash_attention.cuh, which says what is
// computed and how. bf16 calls without a prolog run on the tensor cores
// (flash_attention_tc.cu); this entry point refuses them, so that none lands
// here unseen. The build reads the next line and makes one object per head
// dim, each with its own C entry point.
//
// build-variants: ALG_FLASH_HEAD_DIM=64,80,128
#include "flash_attention.cuh"

namespace {

// Two blocks a multiprocessor: without the hint ptxas squeezes some instantiations into 168 registers
// for a third block and spills q or the accumulator, which costs more than the third block gains.
template <typename T, bool kStable, bool kBias>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, long long bias_b_stride,
                 const int* __restrict__ kv_len, T* __restrict__ out, float* __restrict__ lse,
                 int heads, int sq, int sk, int causal_offset, float scale_log2) {
  flash_fwd_body<T, kStable, kBias, false>(q, k, v, bias, bias_b_stride, kv_len, out, lse, heads, sq, sk,
                                           causal_offset, scale_log2, Prolog{});
}

template <typename T, bool kStable, bool kBias>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   long long bias_b_stride, const void* kv_len, void* out, void* lse, int batch,
                   int heads, int sq, int sk, int causal_offset, float scale, cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<T, kStable, kBias><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), bias_b_stride, static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(lse), heads, sq, sk, causal_offset, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* bias,
                     long long bias_b_stride, const void* kv_len, void* out, void* lse, int batch,
                     int heads, int sq, int sk, int causal_offset, float scale, bool stable,
                     cudaStream_t st) {
  if (bias != nullptr) {
    return stable ? launch<T, true, true>(q, k, v, bias, bias_b_stride, kv_len, out, lse, batch, heads, sq, sk, causal_offset, scale, st)
                  : launch<T, false, true>(q, k, v, bias, bias_b_stride, kv_len, out, lse, batch, heads, sq, sk, causal_offset, scale, st);
  }
  return stable ? launch<T, true, false>(q, k, v, bias, 0, kv_len, out, lse, batch, heads, sq, sk, causal_offset, scale, st)
                : launch<T, false, false>(q, k, v, bias, 0, kv_len, out, lse, batch, heads, sq, sk, causal_offset, scale, st);
}

}  // namespace

// alg_flash_attention_fwd_d<D>. q/out: [B, H, Sq, D], k/v: [B, H, Sk, D],
// contiguous fp32 (`dtype` alg::kFloat32; bf16 returns cudaErrorInvalidValue:
// it goes to alg_flash_attention_tc_fwd_d<D>). bias: null, or fp32 with
// element (b, h, i, j) at b·bias_b_stride + (h·Sq + i)·Sk + j (bias_b_stride
// 0 broadcasts one [H, Sq, Sk] bias over the batch). kv_len: null, or int32
// [B] on the device: batch row b attends to its first kv_len[b] keys
// (clamped to [0, Sk]). causal != 0: query i also sees no key past i + (Sk - Sq). lse:
// null, or fp32 [B, H, Sq] that receives each row's base-2 log-sum-exp.
// Returns the launch's cudaError_t.
extern "C" int ALG_CAT(alg_flash_attention_fwd_d, ALG_FLASH_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    long long bias_b_stride, const void* kv_len, void* out, void* lse, int batch, int heads, int sq,
    int sk, float scale, int stable, int causal, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int causal_offset = causal != 0 ? sk - sq : kNotCausal;
  switch (dtype) {
    case alg::kFloat32:
      return (int)dispatch<float>(q, k, v, bias, bias_b_stride, kv_len, out, lse, batch, heads, sq,
                                  sk, causal_offset, scale, stable != 0, st);
    default:  // bf16 runs on the tensor cores: alg_flash_attention_tc_fwd_d<D>
      return (int)cudaErrorInvalidValue;
  }
}
