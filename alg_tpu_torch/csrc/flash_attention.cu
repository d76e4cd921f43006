// Flash-attention forward over [B, H, S, D], online softmax in base 2, for
// one head dim D fixed at compile time. The build reads the next line and
// makes one object per value, each with its own C entry point.
//
// build-variants: ALG_FLASH_HEAD_DIM=64,80,128
//
// Replaces the TPU kernel alg_tpu/ops/flash_attention.py:_fwd_kernel in the
// variants the CogVideoX, Wan and HunyuanVideo main paths run: dense,
// `stable` true (running max) or false (bounded logits, no max), an optional
// additive fp32 bias [1|B, H, Sq, Sk] (T5's relative-position bias), an
// optional per-batch key count kv_len [B] (UMT5's, Llama's and the Hunyuan
// DiT's prefix mask), Sq != Sk (cross-attention), and `causal` (Llama and the
// CLIP text encoder): query i sees key j iff j <= i + (Sk - Sq). All of them
// compose. Logits are (q.k)·scale·log2e + bias·log2e and p = exp2(logit
// [- running max]).
//
// Design. One thread block of 128 threads per (b·h, tile of query rows). A
// query row belongs to kLanes neighbouring lanes: one lane at D = 64, two at
// D = 80 and 128, so that a lane's slice of the q row and of the fp32
// accumulator (kD / kLanes values each) stays in registers. A lane owns
// every kLanes-th group of four head-dim columns, so the lanes of a row read
// neighbouring float4s of a shared-memory K/V row (no bank conflict). The
// block walks the key sequence in tiles staged in shared memory as fp32 (64
// keys, 32 at D = 128 to stay inside 48 KB; the loop that takes the place of
// the TPU grid's sequential "arbitrary" axis), and inside a tile in chunks of
// 16 keys: 16 partial logits per lane, summed over the row's lanes with one
// shuffle each, their exponentials, then the P·V update of the lane's
// columns. Every lane of a warp reads the same K/V row at a time, so the
// shared-memory reads are broadcasts.
//
// Ragged edges and masks. Every query row has a key limit: row i of batch b
// sees keys j < min(Sk, kv_len[b], i + (Sk - Sq) + 1), the last term only
// when causal (the offset is a run-time argument with a large sentinel for
// "not causal": one integer min a row, no second set of template
// instantiations). The block's key loop ends at the limit of its last row,
// so a causal call skips the tiles and 16-key chunks that none of the block's
// rows can see: about half the work when Sq = Sk. Causal blocks are taken in
// descending row order, longest first. Keys in [block limit, tile end) are
// zero-filled in shared memory; a key at or past a row's own limit is masked
// to -inf, so it adds nothing to numerator or denominator. A row whose
// logits so far are all -inf (an early row of a causal tile, a bias of -inf)
// keeps its running max at -inf; the exponentials then take 0 as the max, so
// they are 0 and not NaN. A row with no visible key at all (kv_len 0, or
// Sq > Sk under causal) writes zeros. Query rows past Sq have limit 0 and
// are not written. No host-side padding, no host read of kv_len.
//
// Residuals (the `return_residuals` variant of the TPU kernel, what the
// backward kernels in flash_attention_bwd.cu and a ring merge need): with a
// non-null `lse` pointer each row also writes the base-2 log-sum-exp of its
// scaled, biased, masked logits, log2(l) plus the running max when stable,
// -inf for a row with no visible key. It is one run-time pointer test at the
// final write; a null pointer is the inference call as it was.
//
// Bound on the H100: tensor-core FLOPs (4·H·D·Σ visible keys per call). This
// version runs on the CUDA cores in fp32 FMAs for both bf16 and fp32 inputs,
// so it sits far below the tensor-core roof; mma/wgmma tiles, TMA staging
// and warp specialisation are later work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#ifndef ALG_FLASH_HEAD_DIM
#error "compile with -DALG_FLASH_HEAD_DIM=64, 80 or 128 (the build-variants line above)"
#endif

#define ALG_CAT_(a, b) a##b
#define ALG_CAT(a, b) ALG_CAT_(a, b)

namespace {

constexpr int kD = ALG_FLASH_HEAD_DIM;       // head dim
constexpr int kLanes = kD > 64 ? 2 : 1;      // lanes that share one query row
constexpr int kDL = kD / kLanes;             // head-dim values a lane owns
constexpr int kThreads = 128;                // threads per block
constexpr int kBlockQ = kThreads / kLanes;   // query rows per block
constexpr int kBlockK = kD > 80 ? 32 : 64;   // keys per shared-memory tile
constexpr int kChunk = 16;                   // keys per logits/exp/P·V round
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNotCausal = 1 << 30;          // causal_offset of a call without the causal mask

static_assert(kD == 64 || kD == 80 || kD == 128, "head dims the port's models use");
static_assert(kD % (4 * kLanes) == 0 && kBlockK % kChunk == 0, "tiling");
static_assert(2 * kBlockK * kD * sizeof(float) <= 48 * 1024, "static shared-memory limit");

// Two blocks a multiprocessor: without the hint ptxas squeezes some instantiations into 168 registers
// for a third block and spills q or the accumulator, which costs more than the third block gains.
template <typename T, bool kStable, bool kBias>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, long long bias_b_stride,
                 const int* __restrict__ kv_len, T* __restrict__ out, float* __restrict__ lse,
                 int heads, int sq, int sk, int causal_offset, float scale_log2) {
  __shared__ __align__(16) float ks[kBlockK][kD];
  __shared__ __align__(16) float vs[kBlockK][kD];

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int part = threadIdx.x % kLanes;  // which of the row's lanes this is
  const bool causal = causal_offset != kNotCausal;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // causal: longest blocks first
  const int row = tile * kBlockQ + threadIdx.x / kLanes;
  const bool valid_row = row < sq;
  const int n_keys = kv_len == nullptr ? sk : max(0, min(sk, kv_len[b]));
  // keys this row sees, and keys the block's last row sees (the block's loop bound)
  const int last_row = min(sq, (tile + 1) * kBlockQ) - 1;
  const int row_keys = !valid_row ? 0 : causal ? max(0, min(n_keys, row + causal_offset + 1)) : n_keys;
  const int block_keys = causal ? max(0, min(n_keys, last_row + causal_offset + 1)) : n_keys;
  const T* kp = k + (long long)bh * sk * kD;
  const T* vp = v + (long long)bh * sk * kD;

  // local value d (a multiple of 4) sits at head-dim column d·kLanes + 4·part
  float qr[kDL];
  if (valid_row) {
    const T* qrow = q + ((long long)bh * sq + row) * kD + 4 * part;
#pragma unroll
    for (int d = 0; d < kDL; d += 4) alg::load4(qrow + d * kLanes, qr + d);
  } else {
#pragma unroll
    for (int d = 0; d < kDL; ++d) qr[d] = 0.0f;
  }
  const float* brow = nullptr;
  if (kBias && valid_row) brow = bias + b * bias_b_stride + ((long long)h * sq + row) * sk;

  float acc[kDL];
#pragma unroll
  for (int d = 0; d < kDL; ++d) acc[d] = 0.0f;
  float m = -INFINITY;  // running max (stable only)
  float l = 0.0f;       // running denominator

  constexpr int kVec = alg::Vec16<T>::N;
  constexpr int kVecsPerTile = kBlockK * kD / kVec;
  for (int k0 = 0; k0 < block_keys; k0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < kVecsPerTile; i += kThreads) {
      const int r = i * kVec / kD, c = i * kVec % kD;
      float kb[kVec], vb[kVec];
      if (k0 + r < block_keys) {
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

    const int kn = min(kBlockK, block_keys - k0);
    for (int j0 = 0; j0 < kn; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) s[jj] = 0.0f;
#pragma unroll
      for (int d = 0; d < kDL; d += 4) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 kv = *reinterpret_cast<const float4*>(&ks[j0 + jj][d * kLanes + 4 * part]);
          s[jj] = fmaf(qr[d], kv.x, s[jj]);
          s[jj] = fmaf(qr[d + 1], kv.y, s[jj]);
          s[jj] = fmaf(qr[d + 2], kv.z, s[jj]);
          s[jj] = fmaf(qr[d + 3], kv.w, s[jj]);
        }
      }
      if (kLanes == 2) {
        // both lanes of a row end with the same sums (a + b == b + a)
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], 1);
      }
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int key = k0 + j0 + jj;
        float t = s[jj] * scale_log2;
        if (kBias && key < row_keys) t += brow[key] * kLog2e;
        s[jj] = key < row_keys ? t : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      float m_exp = 0.0f;  // the max the exponentials are taken against
      if (kStable) {
        const float m_new = fmaxf(m, cmax);
        // all logits so far -inf (no visible key yet, a bias of -inf): take 0, so that p = exp2(-inf) = 0
        m_exp = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = exp2f(m - m_exp);  // 0 while m = -inf
        l *= alpha;
#pragma unroll
        for (int d = 0; d < kDL; ++d) acc[d] *= alpha;
        m = m_new;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = exp2f(s[jj] - m_exp);
        l += s[jj];
      }
#pragma unroll
      for (int d = 0; d < kDL; d += 4) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j0 + jj][d * kLanes + 4 * part]);
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
  T* orow = out + ((long long)bh * sq + row) * kD + 4 * part;
#pragma unroll
  for (int d = 0; d < kDL; d += 4)
    alg::store4(orow + d * kLanes, acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
  if (lse != nullptr && part == 0) {
    // l is taken against the running max when stable (0 while that is -inf), against 0 otherwise
    const float base = (kStable && m != -INFINITY) ? m : 0.0f;
    lse[(long long)bh * sq + row] = l == 0.0f ? -INFINITY : base + log2f(l);
  }
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
// contiguous, of `dtype`. bias: null, or fp32 with element (b, h, i, j) at
// b·bias_b_stride + (h·Sq + i)·Sk + j (bias_b_stride 0 broadcasts one
// [H, Sq, Sk] bias over the batch). kv_len: null, or int32 [B] on the
// device: batch row b attends to its first kv_len[b] keys (clamped to
// [0, Sk]). causal != 0: query i also sees no key past i + (Sk - Sq). lse:
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
    case alg::kBFloat16:
      return (int)dispatch<__nv_bfloat16>(q, k, v, bias, bias_b_stride, kv_len, out, lse, batch,
                                          heads, sq, sk, causal_offset, scale, stable != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
