// Int8 flash attention over [B, H, S, D] for dense self-attention on the CUDA
// cores, for one head dim D fixed at compile time: the route of fp32 inputs
// (ops/flash_attention_int8.py:route; bf16 inputs take the tensor-core kernel,
// flash_attention_int8_tc.cu). The build reads the next line and makes one
// object per value, each with its own C entry point.
//
// build-variants: ALG_INT8_HEAD_DIM=64,128
//
// Replaces the TPU kernel alg_tpu/ops/flash_attention_int8.py:_kernel. Inputs
// are the int8 codes of q and k with one fp32 scale per (b·h, block of
// block_q query rows) and per (b·h, block of block_k keys), as
// ops/flash_attention_int8.py:quantize_qk_int8 makes them (the q scales carry
// scale·log2e). The logits are exact int32 sums of code products (__dp4a),
// p = exp2(logit · sq · sk) in fp32 with no running max (the bounded-logit
// path), keys at or past min(S, kv_len[b]) give p = 0, and
// o = acc / (l == 0 ? 1 : l), so a row that sees no key writes zeros. Two
// modes for the second product:
//
//   "qk"   (pv_int8 = 0): V comes in fp32; P stays fp32 and P·V is fp32
//          FMAs, l = Σ p: the TPU kernel's P·V for fp32 inputs (its rounding
//          of P to the value type is the identity). The entry takes fp32
//          only and returns cudaErrorInvalidValue for bf16, which the wrapper
//          sends to the tensor-core kernel, where P is rounded to bf16 as the
//          TPU kernel rounds it.
//   "full" (pv_int8 = 1): V comes as int8 codes with one fp32 scale per
//          (b·h, channel). For each (query row, block of block_k keys)
//          srow = max(rowmax(p), 1e-37), codes = rint(p · (127 / srow)), 0
//          where p == 0 (so a key block with no visible key adds nothing and
//          no 0 · inf arises), the product of the codes with V's is an exact
//          int32 sum (__dp4a again), and acc += acc32 · (srow / 127) · sv,
//          l += Σ codes · (srow / 127): numerator and denominator from the
//          same codes.
//
// Design. One block of 128 threads per
// (b·h, tile of query rows), a query row on one lane (D = 64) or two
// neighbouring lanes (D = 128), the key loop inside the block over tiles of
// 64 keys staged in shared memory, and inside a tile chunks of 16 keys. A
// lane keeps its share of the q codes as 16 packed words (every kLanes-th
// group of 16 bytes, so the lanes of a row read neighbouring 16-byte pieces
// of a K row) and its share of the fp32 accumulator (every kLanes-th group
// of four columns). K is staged as int8; V as fp32 in "qk" mode, and in
// "full" mode as int8 transposed to [D][64 keys], so that four consecutive
// keys of one channel are one word for __dp4a against four packed P codes.
//
// block_q and block_k are part of the result, not a tiling choice: a row
// reads its own q scale (any block_q), and block_k must be a multiple of the
// 64-key tile so that a tile lies in one key block. In "full" mode the row
// maximum of p over a key block is exp2 of the largest integer logit there
// (exp2 is monotone and sq · sk is one positive number for the pair of
// blocks), so the kernel sweeps a key block twice: once for the largest
// logit, once for the codes and the integer P·V. A key block of one tile
// (block_k = 64) is staged once and only its logits are taken twice.
//
// Bound on the H100: tensor-core operations (2·S²·D a head at the int8 rate
// for QKᵀ, as many at the bf16 or int8 rate for P·V). This version runs on
// the CUDA cores (dp4a, fp32 FMA), far below that: it is the fp32 route and
// the yardstick of the tensor-core kernel.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#ifndef ALG_INT8_HEAD_DIM
#error "compile with -DALG_INT8_HEAD_DIM=64 or 128 (the build-variants line above)"
#endif

#define ALG_CAT_(a, b) a##b
#define ALG_CAT(a, b) ALG_CAT_(a, b)

namespace {

constexpr int kD = ALG_INT8_HEAD_DIM;        // head dim
constexpr int kLanes = kD > 64 ? 2 : 1;      // lanes that share one query row
constexpr int kDL = kD / kLanes;             // accumulator columns a lane owns
constexpr int kGroups = kD / 16 / kLanes;    // 16-byte groups of the q codes a lane owns
constexpr int kThreads = 128;                // threads per block
constexpr int kBlockQ = kThreads / kLanes;   // query rows per block
constexpr int kTile = 64;                    // keys per shared-memory tile (KEY_TILE in the wrapper)
constexpr int kChunk = 16;                   // keys per logits/exp/P·V round

static_assert(kD == 64 || kD == 128, "head dims the int8 path serves");
static_assert(kTile % kChunk == 0 && kChunk % 4 == 0, "tiling");

// the head-dim column of a lane's local accumulator index d
__device__ __forceinline__ int column(int d, int part) { return (d / 4 * 4) * kLanes + 4 * part + d % 4; }

// Keys [k0, k0 + kTile) of K's codes into ks[key][kD]; keys at or past n_keys are zero.
__device__ __forceinline__ void stage_k(const int8_t* __restrict__ kp, int k0, int n_keys, int8_t* ks) {
  for (int i = threadIdx.x; i < kTile * kD / 16; i += kThreads) {
    const int r = i * 16 / kD, c = i * 16 % kD;
    int4 val = make_int4(0, 0, 0, 0);
    if (k0 + r < n_keys) val = *reinterpret_cast<const int4*>(kp + (long long)(k0 + r) * kD + c);
    *reinterpret_cast<int4*>(ks + r * kD + c) = val;
  }
}

// "qk" mode: the same keys of V, of type T, as fp32 into vs[key][kD].
template <typename T>
__device__ __forceinline__ void stage_v_float(const T* __restrict__ vp, int k0, int n_keys, float* vs) {
  constexpr int kVec = alg::Vec16<T>::N;
  for (int i = threadIdx.x; i < kTile * kD / kVec; i += kThreads) {
    const int r = i * kVec / kD, c = i * kVec % kD;
    float vb[kVec];
    if (k0 + r < n_keys) {
      alg::Vec16<T>::load(vp + (long long)(k0 + r) * kD + c, vb);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vb[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(vs + r * kD + c + e) = make_float4(vb[e], vb[e + 1], vb[e + 2], vb[e + 3]);
  }
}

// "full" mode: the same keys of V's codes, transposed into vt[channel][kTile].
__device__ __forceinline__ void stage_v_codes(const int8_t* __restrict__ vp, int k0, int n_keys, int8_t* vt) {
  for (int i = threadIdx.x; i < kTile * kD / 16; i += kThreads) {
    const int r = i * 16 / kD, c = i * 16 % kD;
    int4 val = make_int4(0, 0, 0, 0);
    if (k0 + r < n_keys) val = *reinterpret_cast<const int4*>(vp + (long long)(k0 + r) * kD + c);
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
    for (int e = 0; e < 16; ++e) vt[(c + e) * kTile + r] = bytes[e];
  }
}

// Integer logits of the lane's row against keys [j0, j0 + kChunk) of the staged tile.
__device__ __forceinline__ void chunk_logits(const int (&qw)[4 * kGroups], const int8_t* ks, int j0, int part,
                                             int (&si)[kChunk]) {
#pragma unroll
  for (int jj = 0; jj < kChunk; ++jj) si[jj] = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int4 kv = *reinterpret_cast<const int4*>(ks + (j0 + jj) * kD + 16 * (g * kLanes + part));
      si[jj] = __dp4a(qw[4 * g], kv.x, si[jj]);
      si[jj] = __dp4a(qw[4 * g + 1], kv.y, si[jj]);
      si[jj] = __dp4a(qw[4 * g + 2], kv.z, si[jj]);
      si[jj] = __dp4a(qw[4 * g + 3], kv.w, si[jj]);
    }
  }
  if (kLanes == 2) {
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) si[jj] += __shfl_xor_sync(0xffffffffu, si[jj], 1);
  }
}

template <typename T, bool kFull>
__global__ void __launch_bounds__(kThreads, 2)
flash_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k, const void* __restrict__ v,
                  const float* __restrict__ sq, const float* __restrict__ sk, const float* __restrict__ sv,
                  const int* __restrict__ kv_len, T* __restrict__ out, int heads, int s, int block_q,
                  int block_k) {
  __shared__ __align__(16) int8_t ks[kTile * kD];
  __shared__ __align__(16) unsigned char vbuf[kFull ? kD * kTile : kTile * kD * sizeof(float)];
  __shared__ float svs[kFull ? kD : 1];
  float* vs = reinterpret_cast<float*>(vbuf);    // "qk": [kTile][kD] fp32
  int8_t* vt = reinterpret_cast<int8_t*>(vbuf);  // "full": [kD][kTile] codes

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int part = threadIdx.x % kLanes;
  const int row = blockIdx.x * kBlockQ + threadIdx.x / kLanes;
  const bool valid_row = row < s;
  const int n_keys = kv_len == nullptr ? s : max(0, min(s, kv_len[b]));
  const int row_keys = valid_row ? n_keys : 0;
  const int nq = (s + block_q - 1) / block_q, nk = (s + block_k - 1) / block_k;
  const int8_t* kp = k + (long long)bh * s * kD;
  const float sq_row = valid_row ? sq[(long long)bh * nq + row / block_q] : 0.0f;

  int qw[4 * kGroups];
  if (valid_row) {
    const int8_t* qrow = q + ((long long)bh * s + row) * kD;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int4 val = *reinterpret_cast<const int4*>(qrow + 16 * (g * kLanes + part));
      qw[4 * g] = val.x; qw[4 * g + 1] = val.y; qw[4 * g + 2] = val.z; qw[4 * g + 3] = val.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * kGroups; ++i) qw[i] = 0;
  }
  if constexpr (kFull) {
    for (int i = threadIdx.x; i < kD; i += kThreads) svs[i] = sv[(long long)bh * kD + i];
  }

  float acc[kDL];
#pragma unroll
  for (int d = 0; d < kDL; ++d) acc[d] = 0.0f;
  float l = 0.0f;

  for (int kb0 = 0; kb0 < n_keys; kb0 += block_k) {  // one block of keys that share a K scale (and a P scale)
    const int kb_end = min(n_keys, kb0 + block_k);
    const float sc = sq_row * sk[(long long)bh * nk + kb0 / block_k];
    const bool one_tile = kb_end - kb0 <= kTile;  // the whole key block is one staged tile
    float inv = 0.0f, w = 0.0f;
    int acc32[kFull ? kDL : 1];
    int lsum = 0;
    if constexpr (kFull) {
      // first sweep: the row's largest integer logit among the block's visible keys
      int mx = INT_MIN;
      for (int k0 = kb0; k0 < kb_end; k0 += kTile) {
        __syncthreads();  // previous tile fully consumed
        stage_k(kp, k0, n_keys, ks);
        if (one_tile) stage_v_codes(static_cast<const int8_t*>(v) + (long long)bh * s * kD, k0, n_keys, vt);
        __syncthreads();
        const int kn = min(kTile, kb_end - k0);
        for (int j0 = 0; j0 < kn; j0 += kChunk) {
          int si[kChunk];
          chunk_logits(qw, ks, j0, part, si);
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj)
            if (k0 + j0 + jj < row_keys) mx = max(mx, si[jj]);
        }
      }
      // a row with no visible key here has mx = INT_MIN: srow is the floor, every p below is 0, every code 0
      const float srow = fmaxf(exp2f((float)mx * sc), 1e-37f);
      inv = 127.0f / srow;
      w = srow * (1.0f / 127.0f);
#pragma unroll
      for (int d = 0; d < kDL; ++d) acc32[d] = 0;
    }
    for (int k0 = kb0; k0 < kb_end; k0 += kTile) {
      if (!(kFull && one_tile)) {
        __syncthreads();
        stage_k(kp, k0, n_keys, ks);
        if constexpr (kFull) {
          stage_v_codes(static_cast<const int8_t*>(v) + (long long)bh * s * kD, k0, n_keys, vt);
        } else {
          stage_v_float<T>(static_cast<const T*>(v) + (long long)bh * s * kD, k0, n_keys, vs);
        }
        __syncthreads();
      }
      const int kn = min(kTile, kb_end - k0);
      for (int j0 = 0; j0 < kn; j0 += kChunk) {
        int si[kChunk];
        chunk_logits(qw, ks, j0, part, si);
        if constexpr (kFull) {
          int pk[kChunk / 4];
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) {
            const float p = k0 + j0 + jj < row_keys ? exp2f((float)si[jj] * sc) : 0.0f;
            const int code = p > 0.0f ? min(127, __float2int_rn(p * inv)) : 0;
            lsum += code;
            pk[jj / 4] = jj % 4 == 0 ? code : pk[jj / 4] | (code << (8 * (jj % 4)));
          }
#pragma unroll
          for (int d = 0; d < kDL; ++d) {
            const int4 vv = *reinterpret_cast<const int4*>(vt + column(d, part) * kTile + j0);
            acc32[d] = __dp4a(pk[0], vv.x, acc32[d]);
            acc32[d] = __dp4a(pk[1], vv.y, acc32[d]);
            acc32[d] = __dp4a(pk[2], vv.z, acc32[d]);
            acc32[d] = __dp4a(pk[3], vv.w, acc32[d]);
          }
        } else {
          float p[kChunk];
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) {
            p[jj] = k0 + j0 + jj < row_keys ? exp2f((float)si[jj] * sc) : 0.0f;
            l += p[jj];
          }
#pragma unroll
          for (int d = 0; d < kDL; d += 4) {
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj) {
              const float4 vv = *reinterpret_cast<const float4*>(vs + (j0 + jj) * kD + d * kLanes + 4 * part);
              acc[d] = fmaf(p[jj], vv.x, acc[d]);
              acc[d + 1] = fmaf(p[jj], vv.y, acc[d + 1]);
              acc[d + 2] = fmaf(p[jj], vv.z, acc[d + 2]);
              acc[d + 3] = fmaf(p[jj], vv.w, acc[d + 3]);
            }
          }
        }
      }
    }
    if constexpr (kFull) {
#pragma unroll
      for (int d = 0; d < kDL; ++d) acc[d] += (float)acc32[d] * w * svs[column(d, part)];
      l += (float)lsum * w;
    }
  }

  if (!valid_row) return;
  const float norm = 1.0f / (l == 0.0f ? 1.0f : l);
  T* orow = out + ((long long)bh * s + row) * kD + 4 * part;
#pragma unroll
  for (int d = 0; d < kDL; d += 4)
    alg::store4(orow + d * kLanes, acc[d] * norm, acc[d + 1] * norm, acc[d + 2] * norm, acc[d + 3] * norm);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* sq, const void* sk, const void* sv,
                   const void* kv_len, void* out, int batch, int heads, int s, int block_q, int block_k,
                   bool full, cudaStream_t stream) {
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, batch * heads);
  if (full) {
    flash_int8_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), v, static_cast<const float*>(sq),
        static_cast<const float*>(sk), static_cast<const float*>(sv), static_cast<const int*>(kv_len),
        static_cast<T*>(out), heads, s, block_q, block_k);
  } else {
    flash_int8_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), v, static_cast<const float*>(sq),
        static_cast<const float*>(sk), nullptr, static_cast<const int*>(kv_len), static_cast<T*>(out), heads, s,
        block_q, block_k);
  }
  return cudaGetLastError();
}

}  // namespace

// alg_flash_attention_int8_d<D>. q, k: int8 codes [B·H, S, D]; v: [B·H, S, D]
// of `dtype` (pv_int8 == 0) or int8 codes (pv_int8 != 0); sq: fp32
// [B·H, ceil(S / block_q)] with scale·log2e folded in; sk: fp32
// [B·H, ceil(S / block_k)]; sv: fp32 [B·H, D], read only when pv_int8 != 0;
// kv_len: null, or int32 [B] on the device (clamped to [0, S]); out:
// [B·H, S, D] of `dtype`, which must be fp32 (alg::kFloat32; anything else
// returns cudaErrorInvalidValue). All contiguous, q, k, v and out 16-byte aligned.
// block_k must be a multiple of 64 and at most 65,536 (the int32 P·V sum of a
// key block). Returns the launch's cudaError_t.
extern "C" int ALG_CAT(alg_flash_attention_int8_d, ALG_INT8_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* sq, const void* sk, const void* sv,
    const void* kv_len, void* out, int batch, int heads, int s, int block_q, int block_k, int pv_int8,
    void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0 || (long long)batch * heads > 65535 || block_q <= 0 ||
      block_k < kTile || block_k % kTile != 0 || block_k > 65536 || (pv_int8 != 0 && sv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case alg::kFloat32:
      return (int)launch<float>(q, k, v, sq, sk, sv, kv_len, out, batch, heads, s, block_q, block_k,
                                pv_int8 != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
