// The flash kernel's qk prolog as a pass of its own: a per-head LayerNorm or
// RMS norm over D, then interleaved RoPE, on q and (with prolog_k) on k, in
// one launch ahead of the forward kernels, which then run as they do for a
// call without a prolog. The build reads the next line and makes one object
// per head dim, each with its own C entry point.
//
// build-variants: ALG_QK_HEAD_DIM=64,80,128
//
// Replaces the qk prolog of the TPU kernel alg_tpu/ops/flash_attention.py:
// _fwd_kernel (its `transform`, :138-155; the qk_norm, rope_cos / rope_sin
// and prolog_k arguments). It computes that transform, as the plain version
// ops/flash_attention.py:apply_prolog_plain does: the norm with fp32
// statistics (LayerNorm: the mean, then the mean of the squared deviations;
// RMS: the mean square) and an fp32 affine, its result rounded to T; then
// x·cos + rot(x)·sin with rot(x0, x1) = (-x1, x0) on each pair, the fp32
// [S, D] tables rounded to T, each product and their sum rounded to T, as a
// rotation computed in T rounds them. The affine and the rotation use
// multiplies and adds that are never contracted into an FMA, as the plain
// version's separate ops are not, so in bf16 the two agree bit for bit but
// where a norm result lies on a rounding tie (the statistics are summed in
// another order).
//
// Why a pass of its own, and not the TPU's transform of each K tile inside
// the attention kernel: there the VPU did it beside the MXU, in every one of
// the Sq / block_q query blocks. On the H100 the tensor-core forward is
// already held back by its CUDA-core softmax, and a norm and rotation of a
// 64-key tile costs about as much CUDA-core work as the tile's products and
// softmax. Done once, the transform costs one pass over q and k in memory.
//
// Bound on the H100: bytes. q and k read once, q' and k' written once, the
// fp32 tables (4·S·D bytes each) and the affines read once.
//
// Design (as csrc/qk_prep.cu and csrc/rope.cu). A thread owns 16 bytes of one
// row: 8 bf16 or 4 fp32 values, whole RoPE pairs, so the rotation needs no
// shuffle. A row's kLanes lanes are an aligned group of a warp, kLanes the
// power of two at or above the row's count of 16-byte slots: 8 (bf16) or 16
// (fp32) lanes at D = 64, 16 or 32 at D = 128. A D = 80 row is 160 bytes in
// bf16 (320 in fp32), 10 (20) slots, so it takes 16 (32) lanes of which the
// last 6 (12) hold no column: they load nothing, add 0 to the sums and store
// nothing. The row's statistics are sums over the group by xor shuffles. A
// block of 256 threads takes a tile of 256 / kLanes rows of one tensor (q or
// k) and a chunk of at most kMaxChunk of its B·H heads: it reads its slot of
// the tables (rounded to T) and of the tensor's affine once and keeps them in
// registers, then walks the heads of its chunk kHeadsInFlight at a time
// (their 16-byte loads all issued before the first is used), writing each
// head's slot with one 16-byte store. The blocks of one S tile, q's chunks
// and then k's, are neighbours in the grid, which the card runs at about the
// same time: the first to arrive reads the tile's table rows from device
// memory and the others find them in L2, so the tables cross from device
// memory once a launch. Without RoPE q and k may differ in length
// (cross-attention): the grid covers the longer, and a block past its own
// tensor's rows returns at once. Inputs and outputs are contiguous
// [B, H, S, D].
#include <stdint.h>

#include "common.cuh"

#ifndef ALG_QK_HEAD_DIM
#error "compile with -DALG_QK_HEAD_DIM=64, 80 or 128 (the build-variants line above)"
#endif

#define ALG_CAT_(a, b) a##b
#define ALG_CAT(a, b) ALG_CAT_(a, b)

namespace {

constexpr int kD = ALG_QK_HEAD_DIM;
constexpr int kThreads = 256;
constexpr int kMaxChunk = 8;       // heads a block walks, at most
constexpr int kHeadsInFlight = 4;  // loads a thread issues before it uses the first
constexpr int kNormNone = 0, kNormLayer = 1, kNormRms = 2;  // ops/flash_attention.py:NORM_CODE

static_assert(kD == 64 || kD == 80 || kD == 128, "head dims the port's models use");

// How a row of T splits across lanes.
template <typename T>
struct RowSplit {
  static constexpr int kVec = alg::Vec16<T>::N;                              // values a lane owns
  static constexpr int kSlots = kD / kVec;                                   // 16-byte slots a row
  static constexpr int kLanes = kSlots <= 8 ? 8 : kSlots <= 16 ? 16 : 32;    // lanes a row
  static constexpr int kRows = kThreads / kLanes;                            // rows a block
  static_assert(kD % kVec == 0 && kSlots <= 32, "a row in whole slots, inside one warp");
};

// One launch's operands: q (and k, with k_chunks > 0), their outputs, affines and lengths, the tables.
struct Args {
  const void* q;
  const void* k;
  void* q_out;
  void* k_out;
  const float* q_scale;
  const float* q_bias;
  const float* k_scale;
  const float* k_bias;
  const float* cos_t;
  const float* sin_t;
  int sq, sk;
  int n_heads;            // B·H
  int chunk;              // heads a chunk (the last may be short)
  int q_chunks, k_chunks; // chunks a tile of each tensor (k_chunks 0: q alone)
  float eps;
};

// Sum over the kLanes lanes of an aligned group (all lanes of the warp take part).
template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int kNorm, bool kRope>
__global__ void __launch_bounds__(kThreads) qk_prolog_kernel(const Args a) {
  using V = alg::Vec16<T>;
  using R = RowSplit<T>;
  constexpr int kVec = R::kVec;
  // block (S tile, chunk), q's chunks then k's, fastest
  const int per_tile = a.q_chunks + a.k_chunks;
  const int tile = blockIdx.x / per_tile;
  int j = blockIdx.x - tile * per_tile;
  const bool is_k = j >= a.q_chunks;
  if (is_k) j -= a.q_chunks;
  const int seq = is_k ? a.sk : a.sq;
  const int s = tile * R::kRows + threadIdx.x / R::kLanes;
  if (tile * R::kRows >= seq) return;  // the whole block: its tensor is shorter than the other
  const T* const x = static_cast<const T*>(is_k ? a.k : a.q);
  T* const out = static_cast<T*>(is_k ? a.k_out : a.q_out);
  const float* const scale = is_k ? a.k_scale : a.q_scale;
  const float* const bias = is_k ? a.k_bias : a.q_bias;

  // rows past S (whole groups) and the lanes of a D = 80 row past its last slot take part in the shuffles
  // and store nothing
  const int c = (threadIdx.x % R::kLanes) * kVec;
  const bool col_ok = R::kSlots == R::kLanes || c < kD;
  const bool active = s < seq && col_ok;
  const int s_at = s < seq ? s : 0, c_at = col_ok ? c : 0;

  // this slot of the tables (rounded to T) and of the affine, for every head of the chunk
  float g[kVec], bb[kVec], cs[kVec], sn[kVec];
#pragma unroll
  for (int e = 0; e < kVec; e += 4) {
    if constexpr (kNorm != kNormNone) alg::load4(scale + c_at + e, g + e);
    if constexpr (kNorm == kNormLayer) alg::load4(bias + c_at + e, bb + e);
    if constexpr (kRope) {
      alg::load4(a.cos_t + s_at * kD + c_at + e, cs + e);
      alg::load4(a.sin_t + s_at * kD + c_at + e, sn + e);
    }
  }
  if constexpr (kRope) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      cs[e] = alg::round_to<T>(cs[e]);
      sn[e] = alg::round_to<T>(sn[e]);
    }
  }

  const long long at = (long long)s_at * kD + c_at;  // the slot in head 0
  const long long head = (long long)seq * kD;
  const int first = j * a.chunk;
  const int bh_end = min(a.n_heads, first + a.chunk);
  for (int bh = first; bh < bh_end; bh += kHeadsInFlight) {
    uint4 raw[kHeadsInFlight];
#pragma unroll
    for (int u = 0; u < kHeadsInFlight; ++u)
      raw[u] = active && bh + u < bh_end ? *reinterpret_cast<const uint4*>(x + (bh + u) * head + at)
                                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < kHeadsInFlight; ++u) {
      if (bh + u >= bh_end) break;  // the same for every thread of the block
      float xv[kVec];
      V::unpack(raw[u], xv);
      if constexpr (kNorm != kNormNone) {
        if constexpr (kNorm == kNormLayer) {
          float sum = 0.0f;
#pragma unroll
          for (int e = 0; e < kVec; ++e) sum += xv[e];
          const float mean = group_sum<R::kLanes>(sum) / kD;
#pragma unroll
          for (int e = 0; e < kVec; ++e) xv[e] = col_ok ? xv[e] - mean : 0.0f;  // no column: no deviation
        }
        float sq = 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) sq += xv[e] * xv[e];
        const float r = rsqrtf(group_sum<R::kLanes>(sq) / kD + a.eps);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float y = __fmul_rn(__fmul_rn(xv[e], r), g[e]);
          xv[e] = alg::round_to<T>(kNorm == kNormLayer ? __fadd_rn(y, bb[e]) : y);
        }
      }
      if constexpr (kRope) {
#pragma unroll
        for (int e = 0; e < kVec; e += 2) {
          const float x0 = xv[e], x1 = xv[e + 1];
          xv[e] = alg::round_to<T>(__fsub_rn(alg::round_to<T>(__fmul_rn(x0, cs[e])),
                                             alg::round_to<T>(__fmul_rn(x1, sn[e]))));
          xv[e + 1] = alg::round_to<T>(__fadd_rn(alg::round_to<T>(__fmul_rn(x1, cs[e + 1])),
                                                 alg::round_to<T>(__fmul_rn(x0, sn[e + 1]))));
        }
      }
      if (active) V::store(out + (bh + u) * head + at, xv);
    }
  }
}

template <typename T, int kNorm, bool kRope>
cudaError_t launch(const Args& a, long long blocks, cudaStream_t stream) {
  qk_prolog_kernel<T, kNorm, kRope><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(Args a, int norm, bool rope, cudaStream_t stream) {
  using R = RowSplit<T>;
  const long long rows = a.sq > a.sk ? a.sq : a.sk;
  const long long blocks = (rows + R::kRows - 1) / R::kRows * (a.q_chunks + a.k_chunks);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  switch (norm) {
    case kNormNone:
      return rope ? launch<T, kNormNone, true>(a, blocks, stream) : cudaErrorInvalidValue;
    case kNormLayer:
      return rope ? launch<T, kNormLayer, true>(a, blocks, stream) : launch<T, kNormLayer, false>(a, blocks, stream);
    case kNormRms:
      return rope ? launch<T, kNormRms, true>(a, blocks, stream) : launch<T, kNormRms, false>(a, blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// alg_qk_prolog_d<D>. q: [B, H, Sq, D] and, with prolog_k != 0, k:
// [B, H, Sk, D], contiguous and 16-byte aligned, of `dtype`; q_out (k_out):
// the same shapes, contiguous, which receive the transformed q (k); n_heads
// = B·H. norm: 0 none, 1 LayerNorm, 2 RMS norm, with eps; the fp32 [D]
// affines q_scale, q_bias, k_scale, k_bias (the biases read by LayerNorm
// only, the k ones only with prolog_k); cos, sin: fp32 [S >= Sq, D] RoPE
// tables, or both null for no RoPE (with RoPE and prolog_k, Sq == Sk). All
// fp32 operands contiguous and 16-byte aligned. A norm, RoPE or both; Sq·D,
// Sk·D < 2^31. Returns the launch's cudaError_t (0 on success).
extern "C" int ALG_CAT(alg_qk_prolog_d, ALG_QK_HEAD_DIM)(
    int dtype, const void* q, const void* k, void* q_out, void* k_out, long long n_heads, int sq, int sk,
    int norm, float eps, const void* q_scale, const void* q_bias, const void* k_scale, const void* k_bias,
    const void* cos_t, const void* sin_t, int prolog_k, void* stream) {
  const bool rope = cos_t != nullptr, with_k = prolog_k != 0;
  if (n_heads <= 0 || n_heads > 0x7fffffffLL - kHeadsInFlight || sq <= 0 || (with_k && sk <= 0) ||
      (long long)sq * kD > 0x7fffffffLL || (long long)sk * kD > 0x7fffffffLL || norm < kNormNone ||
      norm > kNormRms || (norm == kNormNone && !rope) || rope != (sin_t != nullptr) ||
      (rope && with_k && sq != sk) || q == nullptr || q_out == nullptr ||
      (with_k && (k == nullptr || k_out == nullptr)) ||
      (norm != kNormNone && (q_scale == nullptr || (with_k && k_scale == nullptr))) ||
      (norm == kNormLayer && (q_bias == nullptr || (with_k && k_bias == nullptr))))
    return (int)cudaErrorInvalidValue;
  // the heads in as few chunks of at most kMaxChunk as there can be, all but the last of one size
  const long long n_chunks = (n_heads + kMaxChunk - 1) / kMaxChunk;
  const int chunk = (int)((n_heads + n_chunks - 1) / n_chunks);
  const Args a{q, k, q_out, k_out, static_cast<const float*>(q_scale), static_cast<const float*>(q_bias),
               static_cast<const float*>(k_scale), static_cast<const float*>(k_bias),
               static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), sq, with_k ? sk : 0,
               (int)n_heads, chunk, (int)n_chunks, with_k ? (int)n_chunks : 0, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case alg::kFloat32:
      return (int)dispatch<float>(a, norm, rope, st);
    case alg::kBFloat16:
      return (int)dispatch<__nv_bfloat16>(a, norm, rope, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
