// Flash-attention forward in bf16 on the tensor cores: every bf16 call (fp32
// calls run on the CUDA cores in flash_attention.cu; a call with a qk prolog
// runs qk_prolog.cu on q and k first). The build reads the next line and
// makes one object per head dim, each with its own C entry point.
//
// build-variants: ALG_FLASH_HEAD_DIM=64,80,128
//
// Replaces the TPU kernel alg_tpu/ops/flash_attention.py:_fwd_kernel for bf16
// inputs: online softmax in base 2 with fp32 accumulation over [B, H, S, D],
// D = 64, 80 or 128; `stable` (running max) or not (bounded logits, no max);
// an optional additive fp32 bias [1|B, H, Sq, Sk]; an optional per-batch key
// count kv_len [B] read on the device; Sq != Sk; `causal` (query i sees key j
// iff j <= i + (Sk - Sq)); and the base-2 row log-sum-exp (`lse`) that the
// backward kernels read. Conventions are those of flash_attention.cu: a
// running max of -inf takes 0 for the exponentials, a row with no visible key
// writes zeros and an LSE of -inf. P is rounded to bf16 before P·V, as the TPU
// kernel does (p.astype(v.dtype)). The denominator, and with it the LSE, is
// the TPU kernel's too: at D = 64 and 80, where that kernel sums the rows on
// its matrix unit through a ones column appended to V (d % 128 != 0), the
// sum of the bf16-rounded p, fp32-accumulated; at D = 128 the sum of the fp32
// p.
//
// Bound on the H100: tensor-core FLOPs, 4·H·D per visible (query, key) pair
// (q·kᵀ and P·V) at 989 TFLOP/s in bf16; the bytes (q, k, v, the output once)
// are 60-300 times fewer at the DiT shapes.
//
// Design (after FlashAttention-2's forward, Dao 2023). One block of 4 warps
// per (b·h, tile of 128 query rows), two m16 row tiles a warp, so that every
// K and V fragment a warp reads from shared memory feeds two products. The q
// tile is staged once in shared memory; at D = 64 its A fragments are read
// into registers once, at D = 80 and 128 again for every key tile by
// ldmatrix, which leaves the registers to the two D-wide fp32 accumulators
// (faster at D = 128 than one row tile with q in registers, despite a few
// spilled registers: PERF.md, PR 6's tiling variants). The block walks the
// keys in 64-key tiles, K and V staged by cp.async into a two-stage ring in
// dynamic shared memory (the next tile's copy overlaps this tile's math),
// swizzled so that ldmatrix reads are free of bank conflicts (mma.cuh). For
// each tile: S = q·kᵀ by mma.sync.m16n8k16 (B fragments by ldmatrix of K),
// scaled by scale·log2e, bias·log2e added, masked; the online softmax runs on
// the accumulator fragments (a lane holds two rows of each m16 tile, so a row
// max or sum is two xor shuffles inside a quad); P goes to bf16 A fragments in
// registers and P·V is a second mma.sync with B fragments by ldmatrix.trans of
// V. At D = 128 the denominator is kept per lane and summed across the quad
// once, at the end; at D = 64 and 80 it is one more mma.sync a 16-key step,
// the bf16 P fragment times a B fragment of ones held in registers (no
// shared-memory read), which leaves the row sum of the rounded p in every
// column of an fp32 accumulator tile: the TPU kernel's ones column, and no
// CUDA-core work beside the rescale.
//
// Masks, as in flash_attention.cu: row i of batch b sees keys j < min(Sk,
// kv_len[b], i + (Sk - Sq) + 1), the last term only when causal. The block's
// key loop ends at its last row's limit; keys past it are zero-filled in
// shared memory and masked; tiles that every row of the block sees whole
// skip the mask. Causal blocks run longest first. Ragged Sq and Sk need no
// host padding: rows past Sq are zero-filled, computed and not written.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

#ifndef ALG_FLASH_HEAD_DIM
#error "compile with -DALG_FLASH_HEAD_DIM=64, 80 or 128 (the build-variants line above)"
#endif

#define ALG_CAT_(a, b) a##b
#define ALG_CAT(a, b) ALG_CAT_(a, b)

namespace {

using bf16 = __nv_bfloat16;
using namespace alg::mma;

constexpr int kD = ALG_FLASH_HEAD_DIM;         // head dim
constexpr int kWarps = 4;
constexpr bool kQInRegisters = kD == 64;       // else q's A fragments are read again for every key tile
constexpr int kThreads = 32 * kWarps;
constexpr int kRowTiles = 2;                   // m16 row tiles a warp
constexpr int kWarpRows = 16 * kRowTiles;
constexpr int kBlockQ = kWarps * kWarpRows;    // query rows a block
constexpr int kBlockK = 64;                    // keys a shared-memory tile
constexpr int kKSteps = kD / 16;               // k16 steps of q·kᵀ
constexpr int kDTiles = kD / 8;                // n8 tiles of the output
constexpr int kKeyTiles = kBlockK / 8;         // n8 tiles of S
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNotCausal = 1 << 30;            // causal_offset of a call without the causal mask
constexpr bool kSumRounded = kD % 128 != 0;    // the denominator sums the bf16 p (the TPU kernel's ones column)
constexpr int kLSlots = kSumRounded ? 4 : 2;   // a row tile's denominator values a lane keeps
constexpr uint32_t kOnes = 0x3f803f80u;        // two bf16 ones: the B fragment of P·1

using TileD = alg::mma::Tile<kD>;
constexpr int kQBytes = TileD::bytes(kBlockQ);
constexpr int kKVBytes = TileD::bytes(kBlockK);
constexpr int kSmemBytes = kQBytes + 4 * kKVBytes;  // q, then two stages of (K, V)

static_assert(kD == 64 || kD == 80 || kD == 128, "head dims the port's models use");
static_assert(kDTiles % 2 == 0 && kKeyTiles % 2 == 0, "ldmatrix.x4 reads two n8 tiles at a time");
static_assert(kRowTiles >= 1 && kBlockK % 16 == 0, "tiles");
static_assert(kSmemBytes <= 227 * 1024, "shared memory of one block");

// l += P·1 over one k16 step: the row sums of the bf16 P fragment pa, fp32-accumulated, in every column of the
// accumulator tile l (a template, so that the D = 128 units, whose l is not a tile, never instantiate it)
template <int N>
__device__ __forceinline__ void add_row_sums(float (&l)[N], const uint32_t (&pa)[4]) {
  mma_bf16(l, pa, kOnes, kOnes);
}

template <bool kStable, bool kBias>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const float* __restrict__ bias, long long bias_b_stride, const int* __restrict__ kv_len,
                    bf16* __restrict__ out, float* __restrict__ lse, int heads, int sq, int sk,
                    int causal_offset, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_addr(smem), s_kv = s_q + kQBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const bool causal = causal_offset != kNotCausal;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // causal: longest blocks first
  const int q0 = tile * kBlockQ;
  const int n_keys = kv_len == nullptr ? sk : max(0, min(sk, kv_len[b]));
  auto keys_of = [&](int row) {  // keys row `row` sees
    return row >= sq ? 0 : causal ? max(0, min(n_keys, row + causal_offset + 1)) : n_keys;
  };
  const int block_keys = keys_of(min(sq, q0 + kBlockQ) - 1);  // the block's last row's limit: the loop bound
  const int whole_keys = keys_of(q0);                         // keys every row of the block sees
  const int n_tiles = (block_keys + kBlockK - 1) / kBlockK;
  const bf16* kp = k + (long long)bh * sk * kD;
  const bf16* vp = v + (long long)bh * sk * kD;

  TileD::stage<kBlockQ, kThreads>(s_q, q + (long long)bh * sq * kD, q0, sq);
  cp_async_commit();
  if (n_tiles > 0) {
    TileD::stage<kBlockK, kThreads>(s_kv, kp, 0, block_keys);
    TileD::stage<kBlockK, kThreads>(s_kv + kKVBytes, vp, 0, block_keys);
  }
  cp_async_commit();
  cp_async_wait<1>();  // q has landed
  __syncthreads();

  uint32_t qf[kQInRegisters ? kRowTiles : 1][kQInRegisters ? kKSteps : 1][4];
  if constexpr (kQInRegisters) {
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[mt][kk], a_order<kD>(s_q, warp * kWarpRows + 16 * mt, 2 * kk, lane));
  }

  // this lane's rows: row_of(mt, half) = first + 16 mt + 8 half
  const int first = q0 + warp * kWarpRows + lane / 4;
  int row_keys[kRowTiles][2];
  const float* brow[kRowTiles][2];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = first + 16 * mt + 8 * hf;
      row_keys[mt][hf] = keys_of(row);
      brow[mt][hf] = kBias && row < sq ? bias + b * bias_b_stride + ((long long)h * sq + row) * sk : nullptr;
    }

  float o[kRowTiles][kDTiles][4];
  // running max (stable only); the denominator: at D = 128 this lane's part of row half hf's in l[mt][hf], at
  // D = 64 and 80 the accumulator tile of P·1, whose element 2 hf holds row half hf's whole sum
  float m[kRowTiles][2], l[kRowTiles][kLSlots];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt) {
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) o[mt][dt][0] = o[mt][dt][1] = o[mt][dt][2] = o[mt][dt][3] = 0.0f;
    m[mt][0] = m[mt][1] = -INFINITY;
#pragma unroll
    for (int i = 0; i < kLSlots; ++i) l[mt][i] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    if (t + 1 < n_tiles) {  // the next tile's copy overlaps this tile's math
      const uint32_t next = s_kv + ((t + 1) & 1) * 2 * kKVBytes;
      TileD::stage<kBlockK, kThreads>(next, kp, k0 + kBlockK, block_keys);
      TileD::stage<kBlockK, kThreads>(next + kKVBytes, vp, k0 + kBlockK, block_keys);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const uint32_t s_k = s_kv + (t & 1) * 2 * kKVBytes, s_v = s_k + kKVBytes;

    float s[kRowTiles][kKeyTiles][4];
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t qa[kRowTiles][4];
#pragma unroll
      for (int mt = 0; mt < kRowTiles; ++mt) {
        if constexpr (kQInRegisters) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[mt][e] = qf[mt][kk][e];
        } else {
          ldmatrix_x4(qa[mt], a_order<kD>(s_q, warp * kWarpRows + 16 * mt, 2 * kk, lane));
        }
      }
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, b_order<kD>(s_k, 16 * np, 2 * kk, lane));
#pragma unroll
        for (int mt = 0; mt < kRowTiles; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt], bk[2], bk[3]);
        }
      }
    }

    // logits in base 2, bias, mask; a lane's columns are k0 + 8 nt + 2 (lane % 4) + {0, 1}
    const bool masked = k0 + kBlockK > whole_keys;
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = k0 + 8 * nt + 2 * (lane % 4), lim = row_keys[mt][hf];
          float x0 = s[mt][nt][2 * hf] * scale_log2, x1 = s[mt][nt][2 * hf + 1] * scale_log2;
          if constexpr (kBias) {
            const float* br = brow[mt][hf];
            if (key + 1 < lim && (sk & 1) == 0) {  // an even Sk keeps every key pair 8-byte aligned
              const float2 bb = *reinterpret_cast<const float2*>(br + key);
              x0 += bb.x * kLog2e;
              x1 += bb.y * kLog2e;
            } else {
              if (key < lim) x0 += br[key] * kLog2e;
              if (key + 1 < lim) x1 += br[key + 1] * kLog2e;
            }
          }
          if (masked) {
            if (key >= lim) x0 = -INFINITY;
            if (key + 1 >= lim) x1 = -INFINITY;
          }
          s[mt][nt][2 * hf] = x0;
          s[mt][nt][2 * hf + 1] = x1;
        }

    // online softmax on the fragments: p = exp2(x - m), the output rescaled when the max moves
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float m_exp = 0.0f;  // the max the exponentials are taken against
        if constexpr (kStable) {
          float cmax = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < kKeyTiles; ++nt) cmax = fmaxf(cmax, fmaxf(s[mt][nt][2 * hf], s[mt][nt][2 * hf + 1]));
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
          const float m_new = fmaxf(m[mt][hf], cmax);
          // all logits so far -inf (no visible key yet, a bias of -inf): take 0, so that p = exp2(-inf) = 0
          m_exp = m_new == -INFINITY ? 0.0f : m_new;
          const float alpha = exp2f(m[mt][hf] - m_exp);  // 0 while the old max is -inf
          if constexpr (kSumRounded) {
            l[mt][2 * hf] *= alpha;
            l[mt][2 * hf + 1] *= alpha;
          } else {
            l[mt][hf] *= alpha;
          }
#pragma unroll
          for (int dt = 0; dt < kDTiles; ++dt) {
            o[mt][dt][2 * hf] *= alpha;
            o[mt][dt][2 * hf + 1] *= alpha;
          }
          m[mt][hf] = m_new;
        }
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) {
          const float p0 = exp2f(s[mt][nt][2 * hf] - m_exp), p1 = exp2f(s[mt][nt][2 * hf + 1] - m_exp);
          if constexpr (!kSumRounded) l[mt][hf] += p0 + p1;
          s[mt][nt][2 * hf] = p0;
          s[mt][nt][2 * hf + 1] = p1;
        }
      }

    // P·V: the accumulators of key tiles 2j and 2j + 1, as bf16 pairs, are the A fragment of key step j
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t pa[kRowTiles][4];
#pragma unroll
      for (int mt = 0; mt < kRowTiles; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * j][0], s[mt][2 * j][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * j][2], s[mt][2 * j][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
        if constexpr (kSumRounded) add_row_sums(l[mt], pa[mt]);
      }
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, a_order<kD>(s_v, 16 * j, 2 * dp, lane));
#pragma unroll
        for (int mt = 0; mt < kRowTiles; ++mt) {
          mma_bf16(o[mt][2 * dp], pa[mt], bv[0], bv[1]);
          mma_bf16(o[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage is read; the next iteration's copy may overwrite it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lsum;
      if constexpr (kSumRounded) {
        lsum = l[mt][2 * hf];  // the whole row's, in every lane of the quad
      } else {
        lsum = l[mt][hf];
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      }
      const int row = first + 16 * mt + 8 * hf;
      if (row >= sq) continue;
      const float inv = 1.0f / (lsum == 0.0f ? 1.0f : lsum);  // a row with no visible key: o = 0
      bf16* orow = out + ((long long)bh * sq + row) * kD + 2 * (lane % 4);
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt)
        alg::store2(orow + 8 * dt, o[mt][dt][2 * hf] * inv, o[mt][dt][2 * hf + 1] * inv);
      if (lse != nullptr && lane % 4 == 0) {
        // l is taken against the running max when stable (0 while that is -inf), against 0 otherwise
        const float base = (kStable && m[mt][hf] != -INFINITY) ? m[mt][hf] : 0.0f;
        lse[(long long)bh * sq + row] = lsum == 0.0f ? -INFINITY : base + log2f(lsum);
      }
    }
}

template <bool kStable, bool kBias>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, long long bias_b_stride,
                   const void* kv_len, void* out, void* lse, int batch, int heads, int sq, int sk,
                   int causal_offset, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_tc_kernel<kStable, kBias>;
  // above 48 KB a block's dynamic shared memory needs this attribute, once per device and instantiation
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((configured >> device) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << device;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * heads);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), bias_b_stride, static_cast<const int*>(kv_len), static_cast<bf16*>(out),
      static_cast<float*>(lse), heads, sq, sk, causal_offset, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// alg_flash_attention_tc_fwd_d<D>: the arguments of alg_flash_attention_fwd_d<D>
// (flash_attention.cu). q/out: [B, H, Sq, D], k/v: [B, H, Sk, D], contiguous
// bf16 (dtype must be alg::kBFloat16; anything else returns
// cudaErrorInvalidValue). bias: null, or fp32 with element (b, h, i, j) at
// b·bias_b_stride + (h·Sq + i)·Sk + j. kv_len: null, or int32 [B] on the
// device. causal != 0: query i also sees no key past i + (Sk - Sq). lse:
// null, or fp32 [B, H, Sq] that receives each row's base-2 log-sum-exp.
// Returns the launch's cudaError_t.
extern "C" int ALG_CAT(alg_flash_attention_tc_fwd_d, ALG_FLASH_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* bias, long long bias_b_stride,
    const void* kv_len, void* out, void* lse, int batch, int heads, int sq, int sk, float scale, int stable,
    int causal, void* stream) {
  if (dtype != alg::kBFloat16 || batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int causal_offset = causal != 0 ? sk - sq : kNotCausal;
  const long long bs = bias != nullptr ? bias_b_stride : 0;
  cudaError_t err;
  if (bias != nullptr) {
    err = stable ? launch<true, true>(q, k, v, bias, bs, kv_len, out, lse, batch, heads, sq, sk, causal_offset,
                                      scale, st)
                 : launch<false, true>(q, k, v, bias, bs, kv_len, out, lse, batch, heads, sq, sk, causal_offset,
                                       scale, st);
  } else {
    err = stable ? launch<true, false>(q, k, v, bias, bs, kv_len, out, lse, batch, heads, sq, sk, causal_offset,
                                       scale, st)
                 : launch<false, false>(q, k, v, bias, bs, kv_len, out, lse, batch, heads, sq, sk, causal_offset,
                                        scale, st);
  }
  return (int)err;
}
