// Flash-attention backward over [B, H, S, D]: two kernels, dQ and dK/dV, for
// one head dim D fixed at compile time. The build reads the next line and
// makes one object per value, each with its own C entry points.
//
// build-variants: ALG_FLASH_HEAD_DIM=64,80,128
//
// Replaces the TPU kernels alg_tpu/ops/flash_attention_bwd.py:_dq_kernel and
// :_dkv_kernel (dense, causal, kv_len, Sq != Sk) for fp32 inputs, where the
// products need full precision (bf16 dq and dkv run on the tensor cores,
// flash_attention_bwd_dq_tc.cu and flash_attention_bwd_tc.cu).
// Given q, k, v, the output cotangent dO, the forward's base-2 row
// log-sum-exp `lse` and delta_i = rowsum(dO_i ⊙ O_i), both fp32 [B, H, Sq]:
//
//   s_ij  = (q_i·k_j)·scale·log2e, masked like the forward: key j is visible
//           to query i of batch b iff j < min(Sk, kv_len[b]) and, when causal,
//           j <= i + (Sk - Sq)
//   p_ij  = exp2(s_ij - lse_i)            (0 where masked)
//   dp_ij = dO_i·v_j
//   ds_ij = p_ij·(dp_ij - delta_i)
//   dQ_i  = scale·Σ_j ds_ij·k_j           (dq kernel; the TPU kernel rounds
//                                          ds to the input dtype first, an
//                                          identity in fp32)
//   dV_j  = Σ_i p_ij·dO_i                 (dkv kernel)
//   dK_j  = scale·Σ_i ds_ij·q_i           (dkv kernel)
//
// Design. Both kernels follow the forward kernel (flash_attention.cu): 128
// threads a block, fp32 FMAs on the CUDA cores, the
// other side's rows staged in shared memory as fp32 and read as broadcast
// float4s, work done in chunks of 16 staged rows. The TPU grid's sequential
// axis becomes a loop inside the block, so every output row has exactly one
// owner: no atomics, and the sums run in one fixed order.
//
//  * dq: one block per (b·h, tile of query rows); loop over key tiles (K and V
//    in shared memory). A query row belongs to kDqLanes neighbouring lanes,
//    each holding its slice of q, dO and the dQ accumulator in registers.
//  * dkv: one block per (b·h, tile of keys); loop over query tiles (Q, dO, lse
//    and delta in shared memory). A key belongs to kDkvLanes neighbouring
//    lanes, each holding its slice of k, v and of the dK and dV accumulators.
//
// The lanes of a row sum their partial dot products with xor shuffles. The
// slices are narrower than the forward's (8 to 40 values) because a lane
// here holds three or four of them: q, dO, dQ, or k, v, dK, dV.
//
// Masks and ragged edges. The dq block's key loop ends at the limit of its
// last row and the dkv block's query loop starts at the first row that sees
// its first key, so a causal call skips what no row of the block can reach.
// Staged rows past the end are zero-filled, and a query past Sq or with
// lse = -inf (no visible key) takes +1e30 for its lse, so p is exactly 0:
// such a row gets dQ = 0 and adds nothing to dK or dV. Keys at or past kv_len
// get dK = dV = 0. P stays in fp32 for the second products, as in the forward
// kernel. No host-side padding, no host read of kv_len.
//
// Bound on the H100: fp32 FLOPs outside the tensor cores (dq three products,
// 6·H·D per visible (query, key) pair; dkv four, 8·H·D) at 67 TFLOP/s.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#ifndef ALG_FLASH_HEAD_DIM
#error "compile with -DALG_FLASH_HEAD_DIM=64, 80 or 128 (the build-variants line above)"
#endif

#define ALG_CAT_(a, b) a##b
#define ALG_CAT(a, b) ALG_CAT_(a, b)

namespace {

constexpr int kD = ALG_FLASH_HEAD_DIM;        // head dim
constexpr int kThreads = 128;                 // threads per block
constexpr int kStage = kD > 80 ? 32 : 64;     // rows of the other side per shared-memory tile
constexpr int kChunk = 16;                    // staged rows per logits/exp/accumulate round
// Lanes that share one row: powers of two that leave each lane a multiple of four head-dim values. These
// were the fastest of those tried on an H100; wider slices spill.
constexpr int kDqLanes = kD > 80 ? 4 : 2;                       // slices of 32, 40, 32 values of q, dO, dQ
constexpr int kDkvLanes = kD == 64 ? 8 : kD == 80 ? 4 : 16;     // slices of 8, 20, 8 values of k, v, dK, dV
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNotCausal = 1 << 30;           // causal_offset of a call without the causal mask
constexpr float kNoRowLse = 1e30f;            // lse of a row that contributes nothing: exp2(s - 1e30) = 0

static_assert(kD == 64 || kD == 80 || kD == 128, "head dims the port's models use");
static_assert(kD % (4 * kDqLanes) == 0 && kD % (4 * kDkvLanes) == 0 && kStage % kChunk == 0, "tiling");
static_assert(2 * kStage * kD * sizeof(float) + 2 * kStage * sizeof(float) <= 48 * 1024,
              "static shared-memory limit");

// Sum over the kL neighbouring lanes that share a row; every lane gets the total.
template <int kL>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int w = 1; w < kL; w *= 2) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// Stage rows [r0, r0 + kStage) of two [rows, kD] matrices into shared memory as fp32; rows at or past
// `limit` become zeros.
template <typename T>
__device__ __forceinline__ void stage_pair(const T* __restrict__ a, const T* __restrict__ b, int r0, int limit,
                                           float (*as)[kD], float (*bs)[kD]) {
  constexpr int kVec = alg::Vec16<T>::N;
  constexpr int kVecsPerTile = kStage * kD / kVec;
  for (int i = threadIdx.x; i < kVecsPerTile; i += kThreads) {
    const int r = i * kVec / kD, c = i * kVec % kD;
    float ab[kVec], bb[kVec];
    if (r0 + r < limit) {
      alg::Vec16<T>::load(a + (long long)(r0 + r) * kD + c, ab);
      alg::Vec16<T>::load(b + (long long)(r0 + r) * kD + c, bb);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) ab[e] = bb[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4) {
      *reinterpret_cast<float4*>(&as[r][c + e]) = make_float4(ab[e], ab[e + 1], ab[e + 2], ab[e + 3]);
      *reinterpret_cast<float4*>(&bs[r][c + e]) = make_float4(bb[e], bb[e + 1], bb[e + 2], bb[e + 3]);
    }
  }
}

// A lane's slice of row `p` (already offset to the lane's first column): local value d (a multiple of 4)
// sits at head-dim column d·kL + 4·part.
template <typename T, int kL>
__device__ __forceinline__ void load_slice(const T* p, float* out) {
#pragma unroll
  for (int d = 0; d < kD / kL; d += 4) alg::load4(p + d * kL, out + d);
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ kv_len, T* __restrict__ dq,
                    int heads, int sq, int sk, int causal_offset, float scale) {
  constexpr int kL = kDqLanes, kDL = kD / kL, kRows = kThreads / kL;
  __shared__ __align__(16) float ks[kStage][kD];
  __shared__ __align__(16) float vs[kStage][kD];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int part = threadIdx.x % kL;
  const bool causal = causal_offset != kNotCausal;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // causal: longest blocks first
  const int row = tile * kRows + threadIdx.x / kL;
  const bool valid_row = row < sq;
  const int n_keys = kv_len == nullptr ? sk : max(0, min(sk, kv_len[b]));
  const int last_row = min(sq, (tile + 1) * kRows) - 1;
  const int row_keys = !valid_row ? 0 : causal ? max(0, min(n_keys, row + causal_offset + 1)) : n_keys;
  const int block_keys = causal ? max(0, min(n_keys, last_row + causal_offset + 1)) : n_keys;
  const T* kp = k + (long long)bh * sk * kD;
  const T* vp = v + (long long)bh * sk * kD;
  const float scale_log2 = scale * kLog2e;

  float qr[kDL], dor[kDL], acc[kDL];
  float lse_r = kNoRowLse, delta_r = 0.0f;
  if (valid_row) {
    const long long at = (long long)bh * sq + row;
    load_slice<T, kL>(q + at * kD + 4 * part, qr);
    load_slice<T, kL>(dout + at * kD + 4 * part, dor);
    lse_r = lse[at];
    if (lse_r == -INFINITY) lse_r = kNoRowLse;
    delta_r = delta[at];
  } else {
#pragma unroll
    for (int d = 0; d < kDL; ++d) qr[d] = dor[d] = 0.0f;
  }
#pragma unroll
  for (int d = 0; d < kDL; ++d) acc[d] = 0.0f;

  for (int k0 = 0; k0 < block_keys; k0 += kStage) {
    __syncthreads();  // previous tile fully consumed
    stage_pair<T>(kp, vp, k0, block_keys, ks, vs);
    __syncthreads();

    const int kn = min(kStage, block_keys - k0);
    for (int j0 = 0; j0 < kn; j0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) s[jj] = dp[jj] = 0.0f;
#pragma unroll
      for (int d = 0; d < kDL; d += 4) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 kv = *reinterpret_cast<const float4*>(&ks[j0 + jj][d * kL + 4 * part]);
          s[jj] = fmaf(qr[d], kv.x, s[jj]);
          s[jj] = fmaf(qr[d + 1], kv.y, s[jj]);
          s[jj] = fmaf(qr[d + 2], kv.z, s[jj]);
          s[jj] = fmaf(qr[d + 3], kv.w, s[jj]);
        }
      }
#pragma unroll
      for (int d = 0; d < kDL; d += 4) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j0 + jj][d * kL + 4 * part]);
          dp[jj] = fmaf(dor[d], vv.x, dp[jj]);
          dp[jj] = fmaf(dor[d + 1], vv.y, dp[jj]);
          dp[jj] = fmaf(dor[d + 2], vv.z, dp[jj]);
          dp[jj] = fmaf(dor[d + 3], vv.w, dp[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float st = lane_sum<kL>(s[jj]), dpt = lane_sum<kL>(dp[jj]);
        const float p = k0 + j0 + jj < row_keys ? exp2f(st * scale_log2 - lse_r) : 0.0f;
        s[jj] = p * (dpt - delta_r);  // ds
      }
#pragma unroll
      for (int d = 0; d < kDL; d += 4) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 kv = *reinterpret_cast<const float4*>(&ks[j0 + jj][d * kL + 4 * part]);
          acc[d] = fmaf(s[jj], kv.x, acc[d]);
          acc[d + 1] = fmaf(s[jj], kv.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[jj], kv.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[jj], kv.w, acc[d + 3]);
        }
      }
    }
  }

  if (!valid_row) return;
  T* orow = dq + ((long long)bh * sq + row) * kD + 4 * part;
#pragma unroll
  for (int d = 0; d < kDL; d += 4)
    alg::store4(orow + d * kL, acc[d] * scale, acc[d + 1] * scale, acc[d + 2] * scale, acc[d + 3] * scale);
}

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ kv_len, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int sq, int sk, int causal_offset, float scale) {
  constexpr int kL = kDkvLanes, kDL = kD / kL, kKeys = kThreads / kL;
  __shared__ __align__(16) float qs[kStage][kD];
  __shared__ __align__(16) float dos[kStage][kD];
  __shared__ float lses[kStage];
  __shared__ float deltas[kStage];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int part = threadIdx.x % kL;
  const bool causal = causal_offset != kNotCausal;
  const int key0 = blockIdx.x * kKeys;  // the first tiles see the most queries: longest blocks first as it is
  const int key = key0 + threadIdx.x / kL;
  const int n_keys = kv_len == nullptr ? sk : max(0, min(sk, kv_len[b]));
  const bool live_key = key < n_keys;
  const T* qp = q + (long long)bh * sq * kD;
  const T* dop = dout + (long long)bh * sq * kD;
  const float* lsep = lse + (long long)bh * sq;
  const float* deltap = delta + (long long)bh * sq;
  const float scale_log2 = scale * kLog2e;

  float kr[kDL], vr[kDL], dkr[kDL], dvr[kDL];
  if (live_key) {
    const long long at = ((long long)bh * sk + key) * kD + 4 * part;
    load_slice<T, kL>(k + at, kr);
    load_slice<T, kL>(v + at, vr);
  } else {
#pragma unroll
    for (int d = 0; d < kDL; ++d) kr[d] = vr[d] = 0.0f;
  }
#pragma unroll
  for (int d = 0; d < kDL; ++d) dkr[d] = dvr[d] = 0.0f;

  // queries below the first one that sees the block's first key see none of its keys; a block whose first
  // key is past kv_len has nothing to do
  int q_begin = key0 < n_keys ? 0 : sq;
  if (causal && q_begin == 0) q_begin = max(0, key0 - causal_offset) / kChunk * kChunk;

  for (int q0 = q_begin; q0 < sq; q0 += kStage) {
    __syncthreads();  // previous tile fully consumed
    stage_pair<T>(qp, dop, q0, sq, qs, dos);
    if (threadIdx.x < kStage) {
      const int i = q0 + threadIdx.x;
      float l = i < sq ? lsep[i] : kNoRowLse;
      if (l == -INFINITY) l = kNoRowLse;
      lses[threadIdx.x] = l;
      deltas[threadIdx.x] = i < sq ? deltap[i] : 0.0f;
    }
    __syncthreads();

    const int qn = min(kStage, sq - q0);
    for (int i0 = 0; i0 < qn; i0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int ii = 0; ii < kChunk; ++ii) s[ii] = dp[ii] = 0.0f;
#pragma unroll
      for (int d = 0; d < kDL; d += 4) {
#pragma unroll
        for (int ii = 0; ii < kChunk; ++ii) {
          const float4 qv = *reinterpret_cast<const float4*>(&qs[i0 + ii][d * kL + 4 * part]);
          s[ii] = fmaf(kr[d], qv.x, s[ii]);
          s[ii] = fmaf(kr[d + 1], qv.y, s[ii]);
          s[ii] = fmaf(kr[d + 2], qv.z, s[ii]);
          s[ii] = fmaf(kr[d + 3], qv.w, s[ii]);
        }
      }
#pragma unroll
      for (int d = 0; d < kDL; d += 4) {
#pragma unroll
        for (int ii = 0; ii < kChunk; ++ii) {
          const float4 dov = *reinterpret_cast<const float4*>(&dos[i0 + ii][d * kL + 4 * part]);
          dp[ii] = fmaf(vr[d], dov.x, dp[ii]);
          dp[ii] = fmaf(vr[d + 1], dov.y, dp[ii]);
          dp[ii] = fmaf(vr[d + 2], dov.z, dp[ii]);
          dp[ii] = fmaf(vr[d + 3], dov.w, dp[ii]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < kChunk; ++ii) {
        const float st = lane_sum<kL>(s[ii]), dpt = lane_sum<kL>(dp[ii]);
        // a query past Sq or without a visible key has lse 1e30 and zero-filled rows: p = 0
        const bool visible = live_key && key <= q0 + i0 + ii + causal_offset;  // always true when not causal
        const float p = visible ? exp2f(st * scale_log2 - lses[i0 + ii]) : 0.0f;
        s[ii] = p;
        dp[ii] = p * (dpt - deltas[i0 + ii]);  // ds
      }
#pragma unroll
      for (int d = 0; d < kDL; d += 4) {
#pragma unroll
        for (int ii = 0; ii < kChunk; ++ii) {
          const float4 dov = *reinterpret_cast<const float4*>(&dos[i0 + ii][d * kL + 4 * part]);
          dvr[d] = fmaf(s[ii], dov.x, dvr[d]);
          dvr[d + 1] = fmaf(s[ii], dov.y, dvr[d + 1]);
          dvr[d + 2] = fmaf(s[ii], dov.z, dvr[d + 2]);
          dvr[d + 3] = fmaf(s[ii], dov.w, dvr[d + 3]);
        }
      }
#pragma unroll
      for (int d = 0; d < kDL; d += 4) {
#pragma unroll
        for (int ii = 0; ii < kChunk; ++ii) {
          const float4 qv = *reinterpret_cast<const float4*>(&qs[i0 + ii][d * kL + 4 * part]);
          dkr[d] = fmaf(dp[ii], qv.x, dkr[d]);
          dkr[d + 1] = fmaf(dp[ii], qv.y, dkr[d + 1]);
          dkr[d + 2] = fmaf(dp[ii], qv.z, dkr[d + 2]);
          dkr[d + 3] = fmaf(dp[ii], qv.w, dkr[d + 3]);
        }
      }
    }
  }

  if (key >= sk) return;
  const long long at = ((long long)bh * sk + key) * kD + 4 * part;
#pragma unroll
  for (int d = 0; d < kDL; d += 4) {
    alg::store4(dk + at + d * kL, dkr[d] * scale, dkr[d + 1] * scale, dkr[d + 2] * scale, dkr[d + 3] * scale);
    alg::store4(dv + at + d * kL, dvr[d], dvr[d + 1], dvr[d + 2], dvr[d + 3]);
  }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, const void* kv_len, void* dq, int batch, int heads, int sq, int sk,
                      int causal_offset, float scale, cudaStream_t stream) {
  constexpr int kRows = kThreads / kDqLanes;
  const dim3 grid((sq + kRows - 1) / kRows, batch * heads);
  flash_bwd_dq_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<T*>(dq), heads, sq, sk, causal_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* delta, const void* kv_len, void* dk, void* dv, int batch, int heads,
                       int sq, int sk, int causal_offset, float scale, cudaStream_t stream) {
  constexpr int kKeys = kThreads / kDkvLanes;
  const dim3 grid((sk + kKeys - 1) / kKeys, batch * heads);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<T*>(dk), static_cast<T*>(dv), heads, sq, sk,
      causal_offset, scale);
  return cudaGetLastError();
}

bool bad_shape(int batch, int heads, int sq, int sk) {
  return batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || (long long)batch * heads > 65535;
}

}  // namespace

// alg_flash_attention_bwd_dq_d<D> and alg_flash_attention_bwd_dkv_d<D>.
// q/dout/dq: [B, H, Sq, D], k/v/dk/dv: [B, H, Sk, D], contiguous, of `dtype`;
// lse/delta: fp32 [B, H, Sq] (lse in base 2 of the scaled logits, -inf on a
// row with no visible key); kv_len: null, or int32 [B] on the device; causal
// != 0 hides from query i the keys past i + (Sk - Sq). `scale` is the
// softmax scale of the forward. Each returns its launch's cudaError_t. Both
// take fp32 only (bf16 returns cudaErrorInvalidValue: it goes to
// alg_flash_attention_bwd_dq_tc_d<D> in flash_attention_bwd_dq_tc.cu and
// alg_flash_attention_bwd_dkv_tc_d<D> in flash_attention_bwd_tc.cu).
extern "C" int ALG_CAT(alg_flash_attention_bwd_dq_d, ALG_FLASH_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_len, void* dq, int batch, int heads, int sq, int sk, float scale,
    int causal, void* stream) {
  if (bad_shape(batch, heads, sq, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int causal_offset = causal != 0 ? sk - sq : kNotCausal;
  switch (dtype) {
    case alg::kFloat32:
      return (int)launch_dq<float>(q, k, v, dout, lse, delta, kv_len, dq, batch, heads, sq, sk,
                                   causal_offset, scale, st);
    default:  // bf16 runs on the tensor cores: alg_flash_attention_bwd_dq_tc_d<D>
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ALG_CAT(alg_flash_attention_bwd_dkv_d, ALG_FLASH_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_len, void* dk, void* dv, int batch, int heads, int sq, int sk,
    float scale, int causal, void* stream) {
  if (bad_shape(batch, heads, sq, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int causal_offset = causal != 0 ? sk - sq : kNotCausal;
  switch (dtype) {
    case alg::kFloat32:
      return (int)launch_dkv<float>(q, k, v, dout, lse, delta, kv_len, dk, dv, batch, heads, sq, sk,
                                    causal_offset, scale, st);
    default:  // bf16 runs on the tensor cores: alg_flash_attention_bwd_dkv_tc_d<D>
      return (int)cudaErrorInvalidValue;
  }
}
