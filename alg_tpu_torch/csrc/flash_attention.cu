// Flash-attention forward in fp32 on the CUDA cores: every fp32 call (a call
// with a qk prolog runs qk_prolog.cu on q and k first). bf16 calls run on the
// tensor cores (flash_attention_tc.cu); this entry point refuses bf16, so that
// none lands here unseen. The build
// reads the next line and makes one object per head dim, each with its own C
// entry point.
//
// build-variants: ALG_FLASH_HEAD_DIM=64,80,128
//
// Replaces the TPU kernel alg_tpu/ops/flash_attention.py:_fwd_kernel for fp32
// inputs (the fp32 CLIP towers, the fp32 agreement and training runs), in
// every variant those calls reach: dense, `stable` true (running max) or false
// (bounded logits, no max), an additive fp32 bias [1|B, H, Sq, Sk], a
// per-batch key count kv_len [B] read on the device, Sq != Sk, `causal` (query
// i sees key j iff j <= i + (Sk - Sq)), D = 64, 80 or 128, and the base-2 row
// log-sum-exp (`lse`) that the backward kernels read. Logits are
// (q.k)·scale·log2e + bias·log2e and p = exp2(logit [- running max]). Every
// product is an fp32 FMA (no TF32, no tensor cores); only the order of the
// sums differs from the plain version, and it is fixed: each output row has
// one owner and no atomics.
//
// Bound on the H100: fp32 FLOPs outside the tensor cores, 4·H·D per visible
// (query, key) pair at 67 TFLOP/s; the bytes are 30-60 times fewer at the
// DiT shapes.
//
// Design (flash_simt.cuh has the layout). One block of 128 threads per (b·h,
// tile of 16·TM query rows). TM = 8 (128 rows) at D = 64 and 80, 4 (64 rows)
// at D = 128, where 128 rows would need more registers than a thread has;
// where that grid would leave SMs idle, TM = 2 or 1 (CLIP's [1,16,257,80]
// and [1,12,77,64]): the launcher picks the instantiation from the shape. The
// q tile is staged once; the block walks the keys in tiles (block_k: 64 keys,
// 32 or 48 in the largest blocks at D = 80 and 128, so that two blocks fit an
// SM), K and V copied by cp.async in turn into a K and a V buffer in dynamic
// shared memory, each copy issued one K or V tile ahead of its use. For each
// key tile: S = q·kᵀ as a TM × (block_k / 8) micro-tile a thread; scale,
// bias and mask; the online softmax on the thread's rows (row max by three
// xor shuffles among the row's 8 lanes); P to shared memory; O += P·V as a
// TM × D/8 micro-tile a thread, held in registers with the rows' running max
// and this lane's part of the denominator, which is summed across the 8
// lanes once, at the end. At D = 64 both products are 8 × 8 micro-tiles, 4
// FMAs per float read from shared memory, what the FMA pipes need to be the
// limit; at D = 128 the q·kᵀ tile is 4 × 6, 2.4 FMAs per float.
//
// Masks: row i of batch b sees keys j < min(Sk, kv_len[b], i + (Sk - Sq) + 1),
// the last term only when causal. The block's key loop ends at its last row's
// limit; keys past it are zero-filled in shared memory; tiles that every row
// of the block sees whole skip the mask. Causal blocks run longest first. A
// row whose logits so far are all -inf keeps its running max at -inf and
// takes 0 for the exponentials, which are then 0 and not NaN. A row with no
// visible key writes zeros and an LSE of -inf. Rows past Sq are zero-filled,
// computed and not written. No host-side padding, no host read of kv_len.
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

using namespace alg::simt;

constexpr int kD = ALG_FLASH_HEAD_DIM;        // head dim
constexpr int kTMLarge = kD == 128 ? 4 : 8;   // rows of a row group when the grid fills the card
constexpr int kDC = kD / kRowLanes;           // head-dim values of a thread's output rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNotCausal = 1 << 30;           // causal_offset of a call without the causal mask

static_assert(kD == 64 || kD == 80 || kD == 128, "head dims the port's models use");

// Keys a shared-memory tile for TM rows a row group: 64 at D = 64; at D = 80 and 128 the largest blocks take
// 32 and 48, so that two blocks fit an SM, and the small blocks 64 and 32.
__host__ __device__ constexpr int block_k(int tm) {
  return kD == 64 ? 64 : kD == 80 ? (tm > 2 ? 32 : 64) : (tm > 2 ? 48 : 32);
}

// Dynamic shared memory of a block with TM rows a row group: q, a K and a V tile, P.
constexpr int smem_floats(int tm) {
  return kGroups * tm * stride(kD) + 2 * block_k(tm) * stride(kD) + kGroups * tm * p_stride(block_k(tm));
}

template <int TM, bool kStable, bool kBias>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ bias, long long bias_b_stride, const int* __restrict__ kv_len,
                 float* __restrict__ out, float* __restrict__ lse, int heads, int sq, int sk,
                 int causal_offset, float scale_log2) {
  constexpr int kBlockQ = kGroups * TM, kBlockK = block_k(TM);
  constexpr int kTN = kBlockK / kRowLanes;  // keys of a thread's S micro-tile
  constexpr int S = stride(kD), PS = p_stride(kBlockK);
  static_assert(kBlockK % kRowLanes == 0 && kBlockK % 4 == 0, "key tile");
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);  // [kBlockQ][S]
  float* const ks = qs + kBlockQ * S;                  // [kBlockK][S]
  float* const vs = ks + kBlockK * S;                  // [kBlockK][S]
  float* const ps = vs + kBlockK * S;                  // [kBlockQ][PS]

  const int tx = threadIdx.x % kRowLanes, ty = threadIdx.x / kRowLanes;
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
  const float* kp = k + (long long)bh * sk * kD;
  const float* vp = v + (long long)bh * sk * kD;

  // K and V are copied in turn, each one K or V tile ahead of its use: V of tile t during q·kᵀ of tile t,
  // K of tile t + 1 during P·V of tile t (one commit group a copy, empty past the last tile)
  auto copy = [&](float* dst, const float* src, int t) {
    if (t < n_tiles) stage<kBlockK, kD>(dst, src, t * kBlockK, block_keys);
    alg::mma::cp_async_commit();
  };
  stage<kBlockQ, kD>(qs, q + (long long)bh * sq * kD, q0, sq);  // q lands with K of tile 0
  copy(ks, kp, 0);

  // this thread's rows: ty + 16 i; its keys in a tile: tx + 8 j
  int row_keys[TM];
  const float* brow[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + kGroups * i;
    row_keys[i] = keys_of(row);
    brow[i] = kBias && row < sq ? bias + b * bias_b_stride + ((long long)h * sq + row) * sk : nullptr;
  }

  float o[TM][kDC];
  float m[TM], l[TM];  // running max (stable only), this lane's part of the denominator
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int e = 0; e < kDC; ++e) o[i][e] = 0.0f;
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    alg::mma::cp_async_wait<0>();  // q and this tile's K have landed
    __syncthreads();                // and every warp is done with the previous tile's V and P
    copy(vs, vp, t);

    float s[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.0f;
    dot_tile<TM, kTN, kD>(s, qs + ty * S, ks + tx * S);

    // logits in base 2, bias, mask, then the online softmax row by row
    const bool masked = k0 + kBlockK > whole_keys;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int lim = row_keys[i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int key = k0 + tx + kRowLanes * j;
        float x = s[i][j] * scale_log2;
        if (kBias && key < lim) x += brow[i][key] * kLog2e;
        s[i][j] = masked && key >= lim ? -INFINITY : x;
      }
      float m_exp = 0.0f;  // the max the exponentials are taken against
      if constexpr (kStable) {
        float cmax = s[i][0];
#pragma unroll
        for (int j = 1; j < kTN; ++j) cmax = fmaxf(cmax, s[i][j]);
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 4));
        const float m_new = fmaxf(m[i], cmax);
        // all logits so far -inf (no visible key yet, a bias of -inf): take 0, so that p = exp2(-inf) = 0
        m_exp = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = exp2f(m[i] - m_exp);  // 0 while the old max is -inf
        l[i] *= alpha;
#pragma unroll
        for (int e = 0; e < kDC; ++e) o[i][e] *= alpha;
        m[i] = m_new;
      }
      float* prow = ps + (ty + kGroups * i) * PS + tx;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float p = exp2f(s[i][j] - m_exp);
        l[i] += p;
        prow[kRowLanes * j] = p;
      }
    }
    alg::mma::cp_async_wait<0>();  // this tile's V has landed
    __syncthreads();                // P is written, and every warp is done with this tile's K
    copy(ks, kp, t + 1);
    pv_tile<TM, kBlockK, kD>(o, ps + ty * PS, vs + tx * Cols<kD>::kVec);
  }
  alg::mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float lsum = l[i];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 4);
    const int row = q0 + ty + kGroups * i;
    if (row >= sq) continue;
    const float inv = 1.0f / (lsum == 0.0f ? 1.0f : lsum);  // a row with no visible key: o = 0
    float* orow = out + ((long long)bh * sq + row) * kD;
#pragma unroll
    for (int c = 0; c < Cols<kD>::kGroupsPerLane; ++c) {
      constexpr int V = Cols<kD>::kVec;
      const float* x = o[i] + V * c;
      if constexpr (V == 4) {
        alg::store4(orow + column<kD>(tx, V * c), x[0] * inv, x[1] * inv, x[2] * inv, x[3] * inv);
      } else {
        alg::store2(orow + column<kD>(tx, V * c), x[0] * inv, x[1] * inv);
      }
    }
    if (lse != nullptr && tx == 0) {
      // l is taken against the running max when stable (0 while that is -inf), against 0 otherwise
      const float base = (kStable && m[i] != -INFINITY) ? m[i] : 0.0f;
      lse[(long long)bh * sq + row] = lsum == 0.0f ? -INFINITY : base + log2f(lsum);
    }
  }
}

template <int TM, bool kStable, bool kBias>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias, long long bias_b_stride,
                   const int* kv_len, float* out, float* lse, int batch, int heads, int sq, int sk,
                   int causal_offset, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<TM, kStable, kBias>;
  constexpr int kBytes = smem_floats(TM) * (int)sizeof(float);
  static_assert(kBytes <= 227 * 1024, "shared memory of one block");
  // above 48 KB a block's dynamic shared memory needs this attribute, once per device and instantiation
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((configured >> device) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << device;
  }
  const dim3 grid((sq + kGroups * TM - 1) / (kGroups * TM), batch * heads);
  kernel<<<grid, kThreads, kBytes, stream>>>(q, k, v, bias, bias_b_stride, kv_len, out, lse, heads, sq, sk,
                                             causal_offset, scale * kLog2e);
  return cudaGetLastError();
}

template <int TM>
cudaError_t dispatch(const float* q, const float* k, const float* v, const float* bias, long long bias_b_stride,
                     const int* kv_len, float* out, float* lse, int batch, int heads, int sq, int sk,
                     int causal_offset, float scale, bool stable, cudaStream_t st) {
  if (bias != nullptr) {
    return stable ? launch<TM, true, true>(q, k, v, bias, bias_b_stride, kv_len, out, lse, batch, heads, sq, sk,
                                           causal_offset, scale, st)
                  : launch<TM, false, true>(q, k, v, bias, bias_b_stride, kv_len, out, lse, batch, heads, sq, sk,
                                            causal_offset, scale, st);
  }
  return stable ? launch<TM, true, false>(q, k, v, bias, 0, kv_len, out, lse, batch, heads, sq, sk, causal_offset,
                                          scale, st)
                : launch<TM, false, false>(q, k, v, bias, 0, kv_len, out, lse, batch, heads, sq, sk, causal_offset,
                                           scale, st);
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
  if (dtype != alg::kFloat32 || batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;  // bf16 runs on the tensor cores: alg_flash_attention_tc_fwd_d<D>
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int causal_offset = causal != 0 ? sk - sq : kNotCausal;
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fb = static_cast<const float*>(bias);
  const int* lens = static_cast<const int*>(kv_len);
  float *fo = static_cast<float*>(out), *fl = static_cast<float*>(lse);
  // 16·kTMLarge rows a block, unless that leaves SMs idle: then 32, or 16 (flash_simt.cuh)
  int tm = 0;
  const cudaError_t err = rows_per_group(sq, (long long)batch * heads, kTMLarge, &tm);
  if (err != cudaSuccess) return (int)err;
  const bool is_stable = stable != 0;
  if (tm == kTMLarge)
    return (int)dispatch<kTMLarge>(fq, fk, fv, fb, bias_b_stride, lens, fo, fl, batch, heads, sq, sk, causal_offset, scale,
                            is_stable, st);
  if (tm == 2)
    return (int)dispatch<2>(fq, fk, fv, fb, bias_b_stride, lens, fo, fl, batch, heads, sq, sk, causal_offset, scale,
                            is_stable, st);
  return (int)dispatch<1>(fq, fk, fv, fb, bias_b_stride, lens, fo, fl, batch, heads, sq, sk, causal_offset, scale,
                          is_stable, st);
}
