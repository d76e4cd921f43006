// Flash-attention forward over [B, H, S, D], online softmax in base 2, for
// one head dim D fixed at compile time (ALG_FLASH_HEAD_DIM), with the qk
// prolog: the body of flash_attention_prolog.cu, its only includer. Calls
// without a prolog run elsewhere: fp32 in flash_attention.cu (register-tiled
// on the CUDA cores), bf16 in flash_attention_tc.cu (tensor cores).
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
// The qk prolog (kProlog; the TPU kernel's qk_norm / rope_cos / rope_sin /
// prolog_k, alg_tpu/ops/flash_attention.py:138-155): a per-head LayerNorm or
// RMS norm over D (fp32 statistics in two passes, fp32 affine, the result
// rounded to the activation type), then interleaved RoPE with the [S, D]
// tables rounded to the activation type (each product and their sum rounded
// to the activation type, as a rotation computed in that type rounds them),
// on the q row as it is loaded and, with prolog_k, on
// every K tile after it is staged. The norm's mode, the presence of the
// tables and prolog_k are run-time fields of one struct, so a prolog costs
// one set of instantiations. q: a lane holds a whole row (D = 64) or half of
// one (one shuffle for each statistic); a RoPE pair (2i, 2i + 1) lies inside
// a lane's groups of four columns. k: the staging loop gives a thread 16
// bytes of a row, not a row, so the tile is transformed in a second pass
// after a barrier, one warp a key row at a time, a lane on the pairs lane,
// lane + 32, ... (neighbouring lanes on neighbouring float2s, statistics by
// warp shuffles), and a second barrier follows. Like the TPU kernel, every
// block of query rows transforms every K tile again. What goes into the
// products is what a tensor of the activation type would hold.
//
// Bound on the H100: tensor-core FLOPs (4·H·D·Σ visible keys per call). This
// body runs on the CUDA cores in fp32 FMAs, for the prolog calls in both
// types.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

#ifndef ALG_FLASH_HEAD_DIM
#error "compile with -DALG_FLASH_HEAD_DIM=64, 80 or 128 (the build-variants line of the including source)"
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

// The qk prolog's arguments (read only by kProlog instantiations). norm: 0 none, 1 LayerNorm, 2 RMS norm;
// the affines are fp32 [D] (the biases LayerNorm's only); cos / sin are fp32 [S, D] or null (no RoPE);
// prolog_k == 0 transforms q alone (the caller brings k transformed).
struct Prolog {
  int norm;
  float eps;
  const float* q_scale;
  const float* q_bias;
  const float* k_scale;
  const float* k_bias;
  const float* cos_t;
  const float* sin_t;
  int prolog_k;
};

constexpr int kNormLayer = 1, kNormRms = 2;

// Norm, affine and rounding of n values x[0..n) of one row whose statistics over D are given: mean
// (LayerNorm only) and the reciprocal root; column(i) is the head-dim column of x[i].
template <typename T, int N, typename Column>
__device__ __forceinline__ void prolog_affine(float (&x)[N], int norm, float mean, float rinv,
                                              const float* __restrict__ g, const float* __restrict__ b,
                                              Column column) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = column(i);
    x[i] = norm == kNormLayer ? alg::round_to<T>((x[i] - mean) * rinv * g[c] + b[c])
                              : alg::round_to<T>(x[i] * rinv * g[c]);
  }
}

// Interleaved RoPE of the pair (x0, x1) at head-dim columns (c, c + 1) of sequence position pos.
template <typename T>
__device__ __forceinline__ void prolog_rope(float& x0, float& x1, const Prolog& pro, long long pos, int c) {
  const float2 cs = *reinterpret_cast<const float2*>(pro.cos_t + pos * kD + c);
  const float2 sn = *reinterpret_cast<const float2*>(pro.sin_t + pos * kD + c);
  const float c0 = alg::round_to<T>(cs.x), c1 = alg::round_to<T>(cs.y);
  const float s0 = alg::round_to<T>(sn.x), s1 = alg::round_to<T>(sn.y);
  // x·cos + rot(x)·sin with rot(x0, x1) = (-x1, x0), each product and the sum rounded to T
  const float y0 = alg::round_to<T>(alg::round_to<T>(x0 * c0) - alg::round_to<T>(x1 * s0));
  const float y1 = alg::round_to<T>(alg::round_to<T>(x1 * c1) + alg::round_to<T>(x0 * s1));
  x0 = y0;
  x1 = y1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The staged K tile ks[kBlockK][kD] through the prolog, rows [0, rows): a warp takes a row at a time.
template <typename T>
__device__ __forceinline__ void prolog_k_tile(float (*ks)[kD], int rows, int k0, const Prolog& pro) {
  constexpr int kPairs = kD / 2;                 // pairs of one row
  constexpr int kPerLane = (kPairs + 31) / 32;   // pairs a lane takes
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float x[2 * kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int pair = lane + 32 * i;
      const float2 val = pair < kPairs ? *reinterpret_cast<const float2*>(&ks[r][2 * pair]) : make_float2(0.0f, 0.0f);
      x[2 * i] = val.x;
      x[2 * i + 1] = val.y;
    }
    if (pro.norm != 0) {
      float sum = 0.0f, mean = 0.0f;
      if (pro.norm == kNormLayer) {
#pragma unroll
        for (int i = 0; i < 2 * kPerLane; ++i) sum += x[i];
        mean = warp_sum(sum) * (1.0f / kD);
      }
      sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        if (lane + 32 * i < kPairs) {  // the zeros of a lane past the row's end are no deviations
          const float d0 = x[2 * i] - mean, d1 = x[2 * i + 1] - mean;
          sum += d0 * d0 + d1 * d1;
        }
      }
      const float rinv = rsqrtf(warp_sum(sum) * (1.0f / kD) + pro.eps);
      prolog_affine<T>(x, pro.norm, mean, rinv, pro.k_scale, pro.k_bias,
                       [lane](int i) { return min(kD - 1, 2 * (lane + 32 * (i / 2)) + i % 2); });
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int pair = lane + 32 * i;
      if (pair < kPairs) {
        if (pro.cos_t != nullptr) prolog_rope<T>(x[2 * i], x[2 * i + 1], pro, k0 + r, 2 * pair);
        *reinterpret_cast<float2*>(&ks[r][2 * pair]) = make_float2(x[2 * i], x[2 * i + 1]);
      }
    }
  }
}

template <typename T, bool kStable, bool kBias, bool kProlog>
__device__ __forceinline__ void
flash_fwd_body(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ bias, long long bias_b_stride,
               const int* __restrict__ kv_len, T* __restrict__ out, float* __restrict__ lse,
               int heads, int sq, int sk, int causal_offset, float scale_log2, const Prolog& pro) {
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
  if constexpr (kProlog) {
    // every lane takes part in the shuffles; a row past Sq holds zeros and is never written
    if (pro.norm != 0) {
      float sum = 0.0f, mean = 0.0f;
      if (pro.norm == kNormLayer) {
#pragma unroll
        for (int d = 0; d < kDL; ++d) sum += qr[d];
        if (kLanes == 2) sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        mean = sum * (1.0f / kD);
      }
      sum = 0.0f;
#pragma unroll
      for (int d = 0; d < kDL; ++d) sum += (qr[d] - mean) * (qr[d] - mean);
      if (kLanes == 2) sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float rinv = rsqrtf(sum * (1.0f / kD) + pro.eps);
      prolog_affine<T>(qr, pro.norm, mean, rinv, pro.q_scale, pro.q_bias,
                       [part](int d) { return (d / 4 * 4) * kLanes + 4 * part + d % 4; });
    }
    if (pro.cos_t != nullptr && valid_row) {
#pragma unroll
      for (int d = 0; d < kDL; d += 2)
        prolog_rope<T>(qr[d], qr[d + 1], pro, row, (d / 4 * 4) * kLanes + 4 * part + d % 4);
    }
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
    if constexpr (kProlog) {
      if (pro.prolog_k != 0) {
        prolog_k_tile<T>(ks, kn, k0, pro);
        __syncthreads();
      }
    }
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

}  // namespace
