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
// Design. 128 threads a block, fp32 FMAs on the CUDA cores. The TPU grid's
// sequential axis becomes a loop inside the block, so every output row has
// exactly one owner: no atomics, and the sums run in one fixed order.
//
//  * dq: one block per (b·h, tile of query rows); loop over key tiles (K and V
//    staged in static shared memory, read as broadcast float4s, in chunks of
//    16 keys). A query row belongs to kDqLanes neighbouring lanes, each
//    holding its slice of q, dO and the dQ accumulator in registers; the
//    lanes of a row sum their partial dot products with xor shuffles.
//  * dkv: register-tiled (flash_simt.cuh has the layout). One block per (b·h,
//    tile of 64 keys; two blocks an SM at D = 64 and 80, one at 128); K and V
//    staged once; a loop over tiles of 32 queries, Q, dO, lse and delta copied
//    by cp.async into a two-stage ring in dynamic shared memory, the next
//    tile's copy in flight while this one is computed. For each query tile,
//    Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as the same micro-tile a thread (4 or 2 keys ×
//    4 queries), so that P and dS = P ⊙ (dP - delta) are formed in registers;
//    they go to shared memory (read back by the same warp), and dV += Pᵀ·dO,
//    dK += dSᵀ·Q run as register-blocked products, each thread owning its
//    keys × every 8th group of head-dim columns of both accumulators. dK is
//    scaled by `scale` once, at the end.
//
// Masks and ragged edges. The dq block's key loop ends at the limit of its
// last row and the dkv block's query loop starts at the first row that sees
// its first key, so a causal call skips what no row of the block can reach;
// dkv applies the mask only on query tiles that some pair of its block does
// not see.
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
#include "flash_simt.cuh"

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
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNotCausal = 1 << 30;           // causal_offset of a call without the causal mask
constexpr float kNoRowLse = 1e30f;            // lse of a row that contributes nothing: exp2(s - 1e30) = 0

static_assert(kD == 64 || kD == 80 || kD == 128, "head dims the port's models use");
static_assert(kD % (4 * kDqLanes) == 0 && kStage % kChunk == 0, "tiling");
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
// dK, dV: register-tiled on the CUDA cores (flash_simt.cuh has the layout)
// ---------------------------------------------------------------------------

namespace dkv {

using namespace alg::simt;

constexpr int kTK = 4;                            // keys of a thread (rows ty + 16 i of the block's keys)
constexpr int kBlockKV = kGroups * kTK;           // keys a block
constexpr int kBlockQ = 32;                       // queries a shared-memory tile
constexpr int kTQ = kBlockQ / kRowLanes;          // queries of a thread's micro-tile (tx + 8 j)
constexpr int kDC = kD / kRowLanes;               // head-dim values of a thread's dK and dV rows
constexpr int S = stride(kD), PS = p_stride(kBlockQ);
// K, V; two stages of (Q, dO, lse, delta); P and dS
constexpr int kSmemFloats = 2 * kBlockKV * S + 2 * (2 * kBlockQ * S + 2 * kBlockQ) + 2 * kBlockKV * PS;
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);
static_assert(kSmemBytes <= 227 * 1024, "shared memory of one block");

__global__ void __launch_bounds__(alg::simt::kThreads, 2)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ kv_len, float* __restrict__ dk,
                     float* __restrict__ dv, int sq, int sk, int heads, int causal_offset, float scale) {
  extern __shared__ float4 smem4[];
  float* const ks = reinterpret_cast<float*>(smem4);   // [kBlockKV][S]
  float* const vs = ks + kBlockKV * S;                  // [kBlockKV][S]
  float* const stages = vs + kBlockKV * S;              // 2 × (Q [kBlockQ][S], dO [kBlockQ][S], lse, delta)
  constexpr int kStageFloats = 2 * kBlockQ * S + 2 * kBlockQ;
  float* const ps = stages + 2 * kStageFloats;          // Pᵀ [kBlockKV][PS]
  float* const dss = ps + kBlockKV * PS;                // dSᵀ [kBlockKV][PS]

  const int tx = threadIdx.x % kRowLanes, ty = threadIdx.x / kRowLanes;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const bool causal = causal_offset != kNotCausal;
  const int key0 = blockIdx.x * kBlockKV;  // the first blocks see the most queries: longest blocks first as it is
  const int n_keys = kv_len == nullptr ? sk : max(0, min(sk, kv_len[b]));
  const float* qp = q + (long long)bh * sq * kD;
  const float* dop = dout + (long long)bh * sq * kD;
  const float* lsep = lse + (long long)bh * sq;
  const float* deltap = delta + (long long)bh * sq;
  const float scale_log2 = scale * kLog2e;

  // queries below the first one that sees the block's first key see none of its keys; a block whose first
  // key is past kv_len has nothing to do
  int q_begin = key0 < n_keys ? 0 : sq;
  if (causal && q_begin == 0) q_begin = min(sq, max(0, key0 - causal_offset));
  const int n_tiles = (sq - q_begin + kBlockQ - 1) / kBlockQ;

  auto stage_queries = [&](int t) {
    float* st = stages + (t & 1) * kStageFloats;
    const int q0 = q_begin + t * kBlockQ;
    stage<kBlockQ, kD>(st, qp, q0, sq);
    stage<kBlockQ, kD>(st + kBlockQ * S, dop, q0, sq);
    stage_vector<kBlockQ>(st + 2 * kBlockQ * S, lsep, q0, sq);
    stage_vector<kBlockQ>(st + 2 * kBlockQ * S + kBlockQ, deltap, q0, sq);
  };
  if (n_tiles > 0) {
    stage<kBlockKV, kD>(ks, k + (long long)bh * sk * kD, key0, n_keys);
    stage<kBlockKV, kD>(vs, v + (long long)bh * sk * kD, key0, n_keys);
    stage_queries(0);
  }
  alg::mma::cp_async_commit();

  float dkr[kTK][kDC], dvr[kTK][kDC];
#pragma unroll
  for (int i = 0; i < kTK; ++i)
#pragma unroll
    for (int e = 0; e < kDC; ++e) dkr[i][e] = dvr[i][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * kBlockQ;
    if (t + 1 < n_tiles) stage_queries(t + 1);  // the next tile's copy overlaps this tile's math
    alg::mma::cp_async_commit();
    alg::mma::cp_async_wait<1>();  // K, V and this tile have landed
    __syncthreads();
    const float* qs = stages + (t & 1) * kStageFloats;
    const float* dos = qs + kBlockQ * S;
    const float* lses = dos + kBlockQ * S;
    const float* deltas = lses + kBlockQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, the same micro-tile a thread: P and dS are formed in registers
    float s[kTK][kTQ], dp[kTK][kTQ];
#pragma unroll
    for (int i = 0; i < kTK; ++i)
#pragma unroll
      for (int j = 0; j < kTQ; ++j) s[i][j] = dp[i][j] = 0.0f;
    dot_tile<kTK, kTQ, kD>(s, ks + ty * S, qs + tx * S);
    dot_tile<kTK, kTQ, kD>(dp, vs + ty * S, dos + tx * S);

    // a tile some pair of which is hidden: keys past kv_len (and past Sk), or the causal mask
    const bool masked = key0 + kBlockKV > n_keys || (causal && key0 + kBlockKV - 1 > q0 + causal_offset);
#pragma unroll
    for (int j = 0; j < kTQ; ++j) {
      const int qi = q0 + tx + kRowLanes * j;
      // a query past Sq or without a visible key (lse -inf) takes lse 1e30: p = 0, so it adds nothing
      float l = lses[tx + kRowLanes * j];
      if (qi >= sq || l == -INFINITY) l = kNoRowLse;
      const float dl = deltas[tx + kRowLanes * j];
#pragma unroll
      for (int i = 0; i < kTK; ++i) {
        const int key = key0 + ty + kGroups * i;
        const bool visible = !masked || (key < n_keys && key <= qi + causal_offset);  // no offset: always true
        const float p = visible ? exp2f(s[i][j] * scale_log2 - l) : 0.0f;
        ps[(ty + kGroups * i) * PS + tx + kRowLanes * j] = p;
        dss[(ty + kGroups * i) * PS + tx + kRowLanes * j] = p * (dp[i][j] - dl);
      }
    }
    __syncwarp();  // a key's P and dS are written and read by the 8 lanes of its row group, all in one warp
    // dV += Pᵀ·dO and dK += dSᵀ·Q
    pv_tile<kTK, kBlockQ, kD>(dvr, ps + ty * PS, dos + tx * Cols<kD>::kVec);
    pv_tile<kTK, kBlockQ, kD>(dkr, dss + ty * PS, qs + tx * Cols<kD>::kVec);
    __syncthreads();  // this stage, P and dS are read; the next iteration's copy may overwrite the stage
  }
  alg::mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kTK; ++i) {
    const int key = key0 + ty + kGroups * i;
    if (key >= sk) continue;
    const long long at = ((long long)bh * sk + key) * kD;
#pragma unroll
    for (int c = 0; c < Cols<kD>::kGroupsPerLane; ++c) {
      constexpr int V = Cols<kD>::kVec;
      const int col = column<kD>(tx, V * c);
      const float* a = dkr[i] + V * c;
      const float* w = dvr[i] + V * c;
      if constexpr (V == 4) {
        alg::store4(dk + at + col, a[0] * scale, a[1] * scale, a[2] * scale, a[3] * scale);
        alg::store4(dv + at + col, w[0], w[1], w[2], w[3]);
      } else {
        alg::store2(dk + at + col, a[0] * scale, a[1] * scale);
        alg::store2(dv + at + col, w[0], w[1]);
      }
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, const void* kv_len, void* dk, void* dv, int batch, int heads, int sq, int sk,
                   int causal_offset, float scale, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory needs this attribute, once per device
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((configured >> device) & 1ull)) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << device;
  }
  const dim3 grid((sk + kBlockKV - 1) / kBlockKV, batch * heads);
  flash_bwd_dkv_kernel<<<grid, alg::simt::kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, heads,
      causal_offset, scale);
  return cudaGetLastError();
}

}  // namespace dkv

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
      return (int)dkv::launch(q, k, v, dout, lse, delta, kv_len, dk, dv, batch, heads, sq, sk, causal_offset,
                              scale, st);
    default:  // bf16 runs on the tensor cores: alg_flash_attention_bwd_dkv_tc_d<D>
      return (int)cudaErrorInvalidValue;
  }
}
