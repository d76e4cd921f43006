// Int8 flash attention on the tensor cores, for bf16 and fp32 inputs, for one
// head dim D fixed at compile time: every CUDA call of
// ops/flash_attention_int8.py (route() sends bf16 to the entry
// alg_flash_attention_int8_tc_d<D> and fp32 to alg_flash_attention_int8_tc_fp32_d<D>;
// each refuses the other type). The build reads the next line and makes one
// object per value, each with both entry points.
//
// build-variants: ALG_INT8_HEAD_DIM=64,128
//
// Replaces the TPU kernel alg_tpu/ops/flash_attention_int8.py:_kernel. Inputs
// are the int8 codes of q and k with one fp32 scale a (b·h, block of block_q
// rows) and a (b·h, block of block_k keys), as
// ops/flash_attention_int8.py:quantize_qk_int8 makes them (the q scales carry
// scale·log2e). The logits are exact int32 sums of code products,
// p = exp2(logit · sq · sk) in fp32 with no running max (the bounded-logit
// path), keys at or past min(S, kv_len[b]) give p = 0, and
// o = acc / (l == 0 ? 1 : l), so a row that sees no key writes zeros. Two
// modes for the second product:
//
//   "qk"   (pv_int8 = 0): V in the inputs' type. bf16: P is rounded to bf16
//          before P·V, as the TPU kernel does (p.astype(v.dtype)), with fp32
//          accumulation. fp32: P stays fp32 and P·V is fp32 FMAs (the TPU
//          kernel's rounding of P to the value type is the identity), with no
//          TF32 and no bf16 rounding anywhere. l = Σ p in fp32 in both.
//   "full" (pv_int8 = 1): V as int8 codes with one fp32 scale a (b·h,
//          channel), handed over transposed, [B·H][D][v_keys], with the keys
//          of every 32-key chunk in the order of int8_pv_key_order
//          (ops/flash_attention_int8.py; see below). For each (query row, key
//          block) srow = max(exp2(max logit · sq · sk), 1e-37), codes =
//          min(127, rint(p · (127 / srow))) where p > 0 and 0 elsewhere, an
//          exact int32 product of the codes with V's, and
//          acc += acc32 · (srow / 127) · sv, l += Σ codes · (srow / 127).
//          Only the output's type differs between bf16 and fp32: one body, so
//          the fp32 output rounded to bf16 is the bf16 output on the same codes.
//
// Bound on the H100: operations, 2·D a visible (query, key) pair for QKᵀ at
// the int8 rate plus 2·D for P·V at the bf16 ("qk", bf16), the int8 ("full")
// or the fp32 rate ("qk", fp32: 67 TFLOP/s outside the tensor cores, which
// take no exact fp32 product; there P·V is 30 times QKᵀ's share of the
// bound). What paces the tensor-core products at D = 64 is neither: it is the
// one exp2 a logit, which runs on the SM's 16-a-clock special-function units
// (S²·B·H of them: about 8 ms at [2,48,17776,64] on 132 SMs at 1.755 GHz).
// fp32 "qk" is bound by its FMAs, and its design feeds them 16 FMAs for each
// 16-byte shared-memory read.
//
// Design (the shape of flash_attention_tc.cu). One block of 4 warps a
// (b·h, tile of query rows), kRowTiles m16 row tiles a warp (two; one in
// "full" mode at D = 128, whose int32 and fp32 accumulators would not both fit
// the registers of two, and one in fp32 "qk" mode at D = 128, whose 16 x 128
// fp32 tile is 64 accumulators a lane), the q codes' A fragments in registers
// for the whole key loop. K codes (and V) come in 64-key tiles through a
// two-stage cp.async ring in dynamic shared memory. Int8 rows are handled as
// rows of D / 2 b16 units, so mma.cuh's tiles and b16 ldmatrix serve them: a
// 16-byte chunk of codes is exactly the k32 A or B fragment's share of 8 rows.
// For each 32-key chunk of a tile: S = q·kᵀ by mma.sync.m16n8k32.s8 (exact
// int32); each logit to fp32 by an integer add and a float subtract
// (|logit| <= 127²·128 < 2^22, so 2^23 + 2^22 + logit is a float whose low
// mantissa bits are the logit: exact, and without the I2F conversion, which
// runs at the exp2's rate); p = exp2 of it times the row's fp32 scale, as the
// plain version computes it, and the key mask.
//   "qk", bf16: p is packed to bf16 pairs, which are the A fragments of
//   m16n8k16 for P·V (the C and A fragments share a layout); V's B
//   fragments by ldmatrix.trans.
//   "qk", fp32: the warp writes its chunk of p, transposed ([key][row]), to a
//   slice of shared memory of its own and, after a __syncwarp, reads it back
//   in the layout of the second product: the lanes form D / 8 column groups
//   and 32 / (D / 8) row groups, and a lane owns an 8 x 8 tile of O (rows
//   8 rg..8 rg + 7 of the warp's, columns 4 cg..4 cg + 3 and D / 2 + 4 cg..),
//   so that a key costs it two 16-byte reads of P and two of V (staged as fp32
//   beside K's codes) for 64 FMAs (flash_simt.cuh's register tiling, inside a
//   warp). The row sums of p stay in the C fragments' layout and meet the
//   output rows once, at the end, through the same slice.
//   "full": each key block is swept twice: first the row's largest visible
//   logit (a lane's maximum, then two xor shuffles inside the quad), then
//   the codes, rounded as the plain version rounds them (an fp32 product,
//   then rint by adding and subtracting 1.5·2^23: two roundings, never one
//   fused multiply-add), packed four to a register as the A fragment of
//   m16n8k32 for P·V against V's codes. A lane's C fragment holds keys 2t,
//   2t+1, 8+2t, 9+2t (and 16 more) of a 32-key chunk where the k32 A fragment
//   wants 4t..4t+3 (and 16 more): integer sums do not depend on the order of
//   the keys, so the wrapper hands V's codes over with every chunk in the
//   order the codes arrive in (int8_pv_key_order), and the codes need no
//   shuffle. ldmatrix has no 8-bit transpose, so V's codes come transposed,
//   [channel][key], from the wrapper too, one copy a call. The codes' int32
//   sums over a key block are folded into the fp32 accumulator at the block's
//   end.
//
// block_q and block_k are part of the result (ops/flash_attention_int8.py):
// a row reads its own q scale, and block_k is a multiple of the 64-key tile,
// so that a tile lies in one key block. In "full" mode the row maximum of p
// over a key block is exp2 of the largest integer logit there (exp2 is
// monotone and sq · sk is one positive number for the pair of blocks). A key
// block of one tile is staged once for both sweeps. kv_len: keys past it are
// zero-filled in shared memory and masked; a row with no visible key writes
// zeros, a key block with none adds nothing.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "flash_simt.cuh"
#include "mma.cuh"

#ifndef ALG_INT8_HEAD_DIM
#error "compile with -DALG_INT8_HEAD_DIM=64 or 128 (the build-variants line above)"
#endif

#define ALG_CAT_(a, b) a##b
#define ALG_CAT(a, b) ALG_CAT_(a, b)

namespace {

using bf16 = __nv_bfloat16;
using namespace alg::mma;

constexpr int kD = ALG_INT8_HEAD_DIM;  // head dim
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;              // keys a shared-memory tile (KEY_TILE in the wrapper)
constexpr int kChunks = kTile / 32;    // 32-key chunks of a tile
constexpr int kKSteps = kD / 32;       // k32 steps of q·kᵀ
constexpr int kDTiles = kD / 8;        // n8 tiles of the output
constexpr int kMagic = 0x4B400000;     // the bits of 1.5·2^23
constexpr float kMagicF = 12582912.0f;  // 1.5·2^23

using TileQK = Tile<kD / 2>;     // int8 rows of kD codes, as kD / 2 b16 units
using TileV = Tile<kD>;          // bf16 rows of V ("qk", bf16)
using TileVt = Tile<kTile / 2>;  // V's codes transposed: a channel's kTile keys ("full")
constexpr int kVFloatStride = alg::simt::stride(kD);  // floats a row of V in fp32 ("qk", fp32)

static_assert(kD == 64 || kD == 128, "head dims the int8 path serves");

// kFull: the mode; T: the type of the output and, in "qk" mode, of V.
template <bool kFull, typename T>
struct Shape {
  static constexpr bool kSimt = !kFull && std::is_same<T, float>::value;  // "qk" in fp32: P·V in fp32 FMAs
  static constexpr int kRowTiles = kD == 128 && (kFull || kSimt) ? 1 : 2;  // m16 row tiles a warp
  static constexpr int kWarpRows = 16 * kRowTiles;
  static constexpr int kBlockQ = kWarps * kWarpRows;
  static constexpr int kQBytes = TileQK::bytes(kBlockQ);
  static constexpr int kKBytes = TileQK::bytes(kTile);
  static constexpr int kVBytes =
      kFull ? TileVt::bytes(kD) : kSimt ? kTile * kVFloatStride * (int)sizeof(float) : TileV::bytes(kTile);
  static constexpr int kStageBytes = kKBytes + kVBytes;
  // "qk", fp32: a warp's slice of P, a 32-key chunk transposed, [key][row] with rows padded by 4 floats (the
  // C fragments' stores of a warp then fall in 32 different banks); it also carries the row sums at the end
  static constexpr int kPStride = kWarpRows + 4;
  static constexpr int kPBytes = kSimt ? kWarps * 32 * kPStride * (int)sizeof(float) : 0;
  static constexpr int kSmemBytes = kQBytes + 2 * kStageBytes + kPBytes;  // q, two stages of (K, V), P
  static_assert(kSmemBytes <= 227 * 1024, "shared memory of one block");
  // "qk", fp32: the second product's lanes, kColGroups column groups of 8 columns by kRowGroups row groups
  // of 8 rows
  static constexpr int kColGroups = kD / 8;
  static constexpr int kRowGroups = 32 / kColGroups;
  static_assert(!kSimt || kRowGroups * 8 == kWarpRows, "an 8 x 8 tile of O a lane");
};

// An int32 logit as fp32, exactly (|s| < 2^22), by an integer add and a float subtract.
__device__ __forceinline__ float logit_float(int s) { return __fsub_rn(__int_as_float(s + kMagic), kMagicF); }

// exp2 as one MUFU.EX2 that flushes subnormal results to zero (exp2f adds a rescaling for them).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The chunk helpers below take a 32-key chunk's int32 logits sacc[mt][j][2 hf + e] (row tile mt, n8 tile j,
// row half hf, key 2 quad + e of the tile), key0 = the key of sacc[.][0][0] in this lane, and sc[mt][hf] = the
// row's q scale times the key block's k scale. With kMasked, keys at or past n_keys are hidden.

// The exponent of p: the logit times the row's scale, -inf for a hidden key (exp2 of it is 0).
template <int kRowTiles, bool kMasked>
__device__ __forceinline__ float exponent(const int (&sacc)[kRowTiles][4][4], const float (&sc)[kRowTiles][2],
                                          int key0, int n_keys, int mt, int j, int hf, int e) {
  const float x = __fmul_rn(logit_float(sacc[mt][j][2 * hf + e]), sc[mt][hf]);
  return kMasked && key0 + 8 * j + e >= n_keys ? -INFINITY : x;
}

// "qk": the chunk's p, also summed into this lane's part of l.
template <int kRowTiles, bool kMasked>
__device__ __forceinline__ void chunk_p(const int (&sacc)[kRowTiles][4][4], const float (&sc)[kRowTiles][2],
                                        int key0, int n_keys, float (&p)[kRowTiles][4][4], float (&l)[kRowTiles][2]) {
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = exp2f(exponent<kRowTiles, kMasked>(sacc, sc, key0, n_keys, mt, j, hf, e));
          l[mt][hf] += pv;
          p[mt][j][2 * hf + e] = pv;
        }
}

// "full", first sweep: this lane's largest visible logit of each row.
template <int kRowTiles, bool kMasked>
__device__ __forceinline__ void chunk_max(const int (&sacc)[kRowTiles][4][4], int key0, int n_keys,
                                          int (&mx)[kRowTiles][2]) {
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = sacc[mt][j][2 * hf + e];
          mx[mt][hf] = max(mx[mt][hf], kMasked && key0 + 8 * j + e >= n_keys ? INT_MIN : s);
        }
}

// "full", second sweep: the chunk's P codes, rint(p · inv) rounded as the plain version rounds them (an fp32
// product, then the magic add: two roundings, never one fused multiply-add), packed as A fragments of
// m16n8k32 (the code of n8 tile j, row half hf, key 2 quad + e at byte 2 (j % 2) + e of register
// 2 (j / 2) + hf) and summed into lsum. The fast path (kExact false) takes exp2 as one MUFU.EX2 that flushes
// subnormal p to zero: with srow >= 2^-118 a p below 2^-126 has the code 0 either way, every p·inv is at most
// 127 after rounding, and p = 0 gives 0, so the low byte of the magic sum is the code. The exact path (for a
// warp with a row of smaller srow, where 127 / srow may overflow) takes exp2f, then the minimum with 127 and
// code 0 where p == 0, as the plain version does.
template <int kRowTiles, bool kMasked, bool kExact>
__device__ __forceinline__ void chunk_codes(const int (&sacc)[kRowTiles][4][4], const float (&sc)[kRowTiles][2],
                                            const float (&inv)[kRowTiles][2], int key0, int n_keys,
                                            uint32_t (&pa)[kRowTiles][4], int (&lsum)[kRowTiles][2]) {
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt) {
    int code[4][2][2];  // in the low byte
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = exponent<kRowTiles, kMasked>(sacc, sc, key0, n_keys, mt, j, hf, e);
          if (kExact) {
            const float p = exp2f(x);
            const int r = __float_as_int(__fadd_rn(__fmul_rn(p, inv[mt][hf]), kMagicF)) - kMagic;
            code[j][hf][e] = p > 0.0f ? min(127, r) : 0;
          } else {
            code[j][hf][e] = __float_as_int(__fadd_rn(__fmul_rn(ex2_ftz(x), inv[mt][hf]), kMagicF));
          }
        }
#pragma unroll
    for (int jp = 0; jp < 2; ++jp)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t lo = __byte_perm(code[2 * jp][hf][0], code[2 * jp][hf][1], 0x0040);
        const uint32_t hi = __byte_perm(code[2 * jp + 1][hf][0], code[2 * jp + 1][hf][1], 0x0040);
        pa[mt][2 * jp + hf] = __byte_perm(lo, hi, 0x5410);
        lsum[mt][hf] = __dp4a((int)pa[mt][2 * jp + hf], 0x01010101, lsum[mt][hf]);
      }
  }
}

// One step of the key loop: a 64-key tile of the key block [kb0, kb_end). phase 0: the "full" mode's sweep
// for the row maximum; 1: the sweep that accumulates P·V ("qk" mode has only this one); 2: both sweeps on a
// key block of one tile, staged once.
struct Step {
  int kb0, kb_end, k0, phase;
};

// "qk", fp32: o[i][c] += Σ over the chunk's 32 keys n of P[8 rg + i][n] · V[n][column c], the lane's 8 x 8 tile
// (columns 4 cg..4 cg + 3 and kD / 2 + 4 cg..), P transposed in the warp's slice pw ([key][row], kPStride
// floats a key), V at vs ([key][kD], kVFloatStride floats a key). Each sum runs over the keys in ascending order.
template <int kPStride>
__device__ __forceinline__ void chunk_pv_fp32(float (&o)[8][8], const float* pw, const float* vs, int rg, int cg) {
#pragma unroll 4
  for (int n = 0; n < 32; ++n) {
    const float4 p0 = *reinterpret_cast<const float4*>(pw + n * kPStride + 8 * rg);
    const float4 p1 = *reinterpret_cast<const float4*>(pw + n * kPStride + 8 * rg + 4);
    const float4 v0 = *reinterpret_cast<const float4*>(vs + n * kVFloatStride + 4 * cg);
    const float4 v1 = *reinterpret_cast<const float4*>(vs + n * kVFloatStride + kD / 2 + 4 * cg);
    const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] = fmaf(pr[i], vv[c], o[i][c]);
  }
}

template <bool kFull, typename T>
__global__ void __launch_bounds__(kThreads)
flash_int8_tc_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k, const void* __restrict__ v,
                     const float* __restrict__ sq, const float* __restrict__ sk, const float* __restrict__ sv,
                     const int* __restrict__ kv_len, T* __restrict__ out, int heads, int s, int block_q,
                     int block_k, int v_keys) {
  using Sh = Shape<kFull, T>;
  constexpr int kRowTiles = Sh::kRowTiles;
  constexpr bool kSimt = Sh::kSimt;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_addr(smem), s_ring = s_q + Sh::kQBytes;
  // "qk", fp32: this warp's slice of P
  float* const pw = reinterpret_cast<float*>(smem + Sh::kQBytes + 2 * Sh::kStageBytes) +
                    threadIdx.x / 32 * 32 * Sh::kPStride;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, quad = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int q0 = blockIdx.x * Sh::kBlockQ;
  const int n_keys = kv_len == nullptr ? s : max(0, min(s, kv_len[b]));
  const int nq = (s + block_q - 1) / block_q, nk = (s + block_k - 1) / block_k;
  const bf16* kp = reinterpret_cast<const bf16*>(k + (long long)bh * s * kD);  // as rows of kD / 2 b16 units

  auto begin_block = [&](Step& st, int kb0) {
    st.kb0 = kb0;
    st.kb_end = min(n_keys, kb0 + block_k);
    st.k0 = kb0;
    st.phase = !kFull ? 1 : st.kb_end - kb0 <= kTile ? 2 : 0;
  };
  auto advance = [&](Step& st) {
    st.k0 += kTile;
    if (st.k0 < st.kb_end) return;
    if (st.phase == 0) {  // the maximum is known: sweep the block again
      st.phase = 1;
      st.k0 = st.kb0;
      return;
    }
    begin_block(st, st.kb0 + block_k);
  };
  auto stage = [&](const Step& st, int slot) {
    const uint32_t dst = s_ring + slot * Sh::kStageBytes;
    TileQK::stage<kTile, kThreads>(dst, kp, st.k0, n_keys);
    if (st.phase == 0) return;  // the maximum's sweep reads no V
    if constexpr (kFull) {
      const int8_t* vt = static_cast<const int8_t*>(v) + (long long)bh * kD * v_keys + st.k0;
      for (int i = threadIdx.x; i < kD * (kTile / 16); i += kThreads) {
        const int r = i / (kTile / 16), c = i % (kTile / 16);
        cp_async16(dst + Sh::kKBytes + TileVt::offset(r, c), vt + (long long)r * v_keys + 16 * c, true);
      }
    } else if constexpr (kSimt) {
      alg::simt::stage<kTile, kD>(reinterpret_cast<float*>(smem + (dst - s_q) + Sh::kKBytes),
                                  static_cast<const float*>(v) + (long long)bh * s * kD, st.k0, n_keys);
    } else {
      TileV::stage<kTile, kThreads>(dst + Sh::kKBytes, static_cast<const bf16*>(v) + (long long)bh * s * kD,
                                             st.k0, n_keys);
    }
  };

  Step cur, nxt;
  begin_block(cur, 0);
  nxt = cur;
  advance(nxt);
  TileQK::stage<Sh::kBlockQ, kThreads>(s_q, reinterpret_cast<const bf16*>(q + (long long)bh * s * kD), q0,
                                                s);
  if (n_keys > 0) stage(cur, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[kRowTiles][kKSteps][4];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      ldmatrix_x4(qf[mt][kk], a_order<kD / 2>(s_q, warp * Sh::kWarpRows + 16 * mt, 2 * kk, lane));

  // this lane's rows: first + 16 mt + 8 hf
  const int first = q0 + warp * Sh::kWarpRows + lane / 4;
  float sq_row[kRowTiles][2];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = first + 16 * mt + 8 * hf;
      sq_row[mt][hf] = row < s ? sq[(long long)bh * nq + row / block_q] : 0.0f;
    }

  // O in the C fragments' layout (tensor-core P·V), or as the lane's 8 x 8 tile ("qk", fp32: os[i][c], row
  // 8 rg + i of the warp's, column 4 cg + c, or kD / 2 + 4 cg + c - 4 for c >= 4)
  constexpr int kOT = kSimt ? 1 : kRowTiles, kODT = kSimt ? 1 : kDTiles, kOS = kSimt ? 8 : 1;
  float o[kOT][kODT][4], os[kOS][kOS];
  float l[kRowTiles][2];  // "qk": this lane's part of Σ p; "full": the row's Σ codes · w over the blocks so far
#pragma unroll
  for (int mt = 0; mt < kOT; ++mt)
#pragma unroll
    for (int dt = 0; dt < kODT; ++dt) o[mt][dt][0] = o[mt][dt][1] = o[mt][dt][2] = o[mt][dt][3] = 0.0f;
#pragma unroll
  for (int i = 0; i < kOS; ++i)
#pragma unroll
    for (int c = 0; c < kOS; ++c) os[i][c] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt) l[mt][0] = l[mt][1] = 0.0f;
  const int rg = lane / Sh::kColGroups, cg = lane % Sh::kColGroups;  // "qk", fp32: the lane's tile of O
  // "full" mode: the key block's int32 P·V and code sums, the row's largest logit, its P scale as 127 / srow
  // and srow / 127, and whether the codes may take the fast path (every row of the warp with srow >= 2^-118)
  constexpr int kF = kFull ? kRowTiles : 1;
  int acc32[kF][kFull ? kDTiles : 1][4];
  int lsum[kF][2], mx[kF][2];
  float inv[kF][2], w[kF][2];
  bool fast = true;

  // S = q·kᵀ over one 32-key chunk of the staged K tile: n8 tiles j = 0..3, keys 32 c + 8 j + 2 quad + {0, 1}
  auto logits = [&](uint32_t s_k, int c, int (&sacc)[kRowTiles][4][4]) {
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[mt][j][0] = sacc[mt][j][1] = sacc[mt][j][2] = sacc[mt][j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, b_order<kD / 2>(s_k, 32 * c + 16 * np, 2 * kk, lane));
#pragma unroll
        for (int mt = 0; mt < kRowTiles; ++mt) {
          mma_s8(sacc[mt][2 * np], qf[mt][kk], bk[0], bk[1]);
          mma_s8(sacc[mt][2 * np + 1], qf[mt][kk], bk[2], bk[3]);
        }
      }
  };
  for (int it = 0; cur.kb0 < n_keys; ++it) {
    if (nxt.kb0 < n_keys) stage(nxt, (it + 1) & 1);  // the next tile's copy overlaps this tile's math
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const uint32_t s_k = s_ring + (it & 1) * Sh::kStageBytes, s_v = s_k + Sh::kKBytes;
    const float skb = sk[(long long)bh * nk + cur.kb0 / block_k];
    const int k0 = cur.k0;
    const bool masked = k0 + kTile > n_keys;  // the only tile that reaches past the visible keys
    const bool block_start = k0 == cur.kb0, block_end = k0 + kTile >= cur.kb_end;
    float sc[kRowTiles][2];  // the rows' scales in this key block
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt) sc[mt][0] = sq_row[mt][0] * skb, sc[mt][1] = sq_row[mt][1] * skb;

    if constexpr (kFull) {
      if (cur.phase != 1) {  // the row's largest visible logit in this key block
        if (block_start) {
#pragma unroll
          for (int mt = 0; mt < kRowTiles; ++mt) mx[mt][0] = mx[mt][1] = INT_MIN;
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          int sacc[kRowTiles][4][4];
          logits(s_k, c, sacc);
          const int key0 = k0 + 32 * c + 2 * quad;
          if (masked) {
            chunk_max<kRowTiles, true>(sacc, key0, n_keys, mx);
          } else {
            chunk_max<kRowTiles, false>(sacc, key0, n_keys, mx);
          }
        }
        if (block_end) {  // the whole row's maximum; a row with no visible key keeps INT_MIN: srow is the floor
          bool rows_fast = true;
#pragma unroll
          for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              int m = mx[mt][hf];
              m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
              m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
              const float srow = fmaxf(exp2f((float)m * sc[mt][hf]), 1e-37f);
              inv[mt][hf] = 127.0f / srow;
              w[mt][hf] = srow * (1.0f / 127.0f);
              rows_fast = rows_fast && srow >= 0x1p-118f;
            }
          fast = __all_sync(0xffffffffu, rows_fast);
        }
      }
      if (cur.phase != 0) {  // the codes and their integer P·V
        if (block_start) {
#pragma unroll
          for (int mt = 0; mt < kRowTiles; ++mt) {
            lsum[mt][0] = lsum[mt][1] = 0;
#pragma unroll
            for (int dt = 0; dt < kDTiles; ++dt)
              acc32[mt][dt][0] = acc32[mt][dt][1] = acc32[mt][dt][2] = acc32[mt][dt][3] = 0;
          }
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          int sacc[kRowTiles][4][4];
          logits(s_k, c, sacc);
          const int key0 = k0 + 32 * c + 2 * quad;
          uint32_t pa[kRowTiles][4];
          if (masked) {
            if (fast) {
              chunk_codes<kRowTiles, true, false>(sacc, sc, inv, key0, n_keys, pa, lsum);
            } else {
              chunk_codes<kRowTiles, true, true>(sacc, sc, inv, key0, n_keys, pa, lsum);
            }
          } else if (fast) {
            chunk_codes<kRowTiles, false, false>(sacc, sc, inv, key0, n_keys, pa, lsum);
          } else {
            chunk_codes<kRowTiles, false, true>(sacc, sc, inv, key0, n_keys, pa, lsum);
          }
#pragma unroll
          for (int dp = 0; dp < kDTiles / 2; ++dp) {
            uint32_t bv[4];
            ldmatrix_x4(bv, b_order<kTile / 2>(s_v, 16 * dp, 2 * c, lane));
#pragma unroll
            for (int mt = 0; mt < kRowTiles; ++mt) {
              mma_s8(acc32[mt][2 * dp], pa[mt], bv[0], bv[1]);
              mma_s8(acc32[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
            }
          }
        }
        if (block_end) {  // fold the key block in: acc += acc32 · w · sv, l += Σ codes · w
#pragma unroll
          for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              int n = lsum[mt][hf];
              n += __shfl_xor_sync(0xffffffffu, n, 1);
              n += __shfl_xor_sync(0xffffffffu, n, 2);
              l[mt][hf] += __fmul_rn((float)n, w[mt][hf]);
            }
#pragma unroll
          for (int dt = 0; dt < kDTiles; ++dt) {
            const float2 svc = *reinterpret_cast<const float2*>(sv + (long long)bh * kD + 8 * dt + 2 * quad);
#pragma unroll
            for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                o[mt][dt][2 * hf] += __fmul_rn(__fmul_rn(__int2float_rn(acc32[mt][dt][2 * hf]), w[mt][hf]), svc.x);
                o[mt][dt][2 * hf + 1] +=
                    __fmul_rn(__fmul_rn(__int2float_rn(acc32[mt][dt][2 * hf + 1]), w[mt][hf]), svc.y);
              }
          }
        }
      }
    } else if constexpr (kSimt) {
      const float* vs = reinterpret_cast<const float*>(smem + (s_v - s_q));  // this tile's V in fp32
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        int sacc[kRowTiles][4][4];
        logits(s_k, c, sacc);
        const int key0 = k0 + 32 * c + 2 * quad;
        float p[kRowTiles][4][4];
        if (masked) {
          chunk_p<kRowTiles, true>(sacc, sc, key0, n_keys, p, l);
        } else {
          chunk_p<kRowTiles, false>(sacc, sc, key0, n_keys, p, l);
        }
        // P into the warp's slice, transposed: row 16 mt + 8 hf + lane / 4, key 8 j + 2 quad + e of the chunk
        __syncwarp();  // the previous chunk's P is read
#pragma unroll
        for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                pw[(8 * j + 2 * quad + e) * Sh::kPStride + 16 * mt + 8 * hf + lane / 4] = p[mt][j][2 * hf + e];
        __syncwarp();
        chunk_pv_fp32<Sh::kPStride>(os, pw, vs + 32 * c * kVFloatStride, rg, cg);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        int sacc[kRowTiles][4][4];
        logits(s_k, c, sacc);
        const int key0 = k0 + 32 * c + 2 * quad;
        float p[kRowTiles][4][4];
        if (masked) {
          chunk_p<kRowTiles, true>(sacc, sc, key0, n_keys, p, l);
        } else {
          chunk_p<kRowTiles, false>(sacc, sc, key0, n_keys, p, l);
        }
        // P·V: the p of n8 tiles 2 jj and 2 jj + 1, as bf16 pairs, are the A fragment of key step jj
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t pa[kRowTiles][4];
#pragma unroll
          for (int mt = 0; mt < kRowTiles; ++mt) {
            pa[mt][0] = pack_bf16(p[mt][2 * jj][0], p[mt][2 * jj][1]);
            pa[mt][1] = pack_bf16(p[mt][2 * jj][2], p[mt][2 * jj][3]);
            pa[mt][2] = pack_bf16(p[mt][2 * jj + 1][0], p[mt][2 * jj + 1][1]);
            pa[mt][3] = pack_bf16(p[mt][2 * jj + 1][2], p[mt][2 * jj + 1][3]);
          }
#pragma unroll
          for (int dp = 0; dp < kDTiles / 2; ++dp) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, a_order<kD>(s_v, 32 * c + 16 * jj, 2 * dp, lane));
#pragma unroll
            for (int mt = 0; mt < kRowTiles; ++mt) {
              mma_bf16(o[mt][2 * dp], pa[mt], bv[0], bv[1]);
              mma_bf16(o[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage is read; the next iteration's copy may overwrite it
    cur = nxt;
    advance(nxt);
  }
  cp_async_wait<0>();

  if constexpr (kSimt) {
    // the row sums, whole in each lane of a quad, through the warp's slice to the lanes that own the rows
    __syncwarp();  // the last chunk's P is read
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float lsum_row = l[mt][hf];
        lsum_row += __shfl_xor_sync(0xffffffffu, lsum_row, 1);
        lsum_row += __shfl_xor_sync(0xffffffffu, lsum_row, 2);
        if (quad == 0) pw[16 * mt + 8 * hf + lane / 4] = lsum_row;
      }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + warp * Sh::kWarpRows + 8 * rg + i;
      const float lsum_row = pw[8 * rg + i];
      if (row >= s) continue;
      const float denom = lsum_row == 0.0f ? 1.0f : lsum_row;  // a row with no visible key: o = 0
      T* orow = out + ((long long)bh * s + row) * kD + 4 * cg;
      alg::store4(orow, os[i][0] / denom, os[i][1] / denom, os[i][2] / denom, os[i][3] / denom);
      alg::store4(orow + kD / 2, os[i][4] / denom, os[i][5] / denom, os[i][6] / denom, os[i][7] / denom);
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float lsum_row = l[mt][hf];
        if constexpr (!kFull) {  // "full" folded whole rows already
          lsum_row += __shfl_xor_sync(0xffffffffu, lsum_row, 1);
          lsum_row += __shfl_xor_sync(0xffffffffu, lsum_row, 2);
        }
        const int row = first + 16 * mt + 8 * hf;
        if (row >= s) continue;
        const float denom = lsum_row == 0.0f ? 1.0f : lsum_row;  // a row with no visible key: o = 0
        T* orow = out + ((long long)bh * s + row) * kD + 2 * quad;
#pragma unroll
        for (int dt = 0; dt < kDTiles; ++dt)
          alg::store2(orow + 8 * dt, o[mt][dt][2 * hf] / denom, o[mt][dt][2 * hf + 1] / denom);
      }
  }
}

template <bool kFull, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* sq, const void* sk, const void* sv,
                   const void* kv_len, void* out, int batch, int heads, int s, int block_q, int block_k, int v_keys,
                   cudaStream_t stream) {
  using Sh = Shape<kFull, T>;
  auto kernel = flash_int8_tc_kernel<kFull, T>;
  // above 48 KB a block's dynamic shared memory needs this attribute, once per device and instantiation
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((configured >> device) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmemBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << device;
  }
  const dim3 grid((s + Sh::kBlockQ - 1) / Sh::kBlockQ, batch * heads);
  kernel<<<grid, kThreads, Sh::kSmemBytes, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), v, static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<const float*>(sv), static_cast<const int*>(kv_len),
      static_cast<T*>(out), heads, s, block_q, block_k, v_keys);
  return cudaGetLastError();
}

// Both entry points: the checks, then the instantiation of the mode for output type T (`want`, the only
// dtype the entry takes).
template <typename T>
int entry(int want, int dtype, const void* q, const void* k, const void* v, const void* sq, const void* sk,
          const void* sv, const void* kv_len, void* out, int batch, int heads, int s, int block_q, int block_k,
          int pv_int8, int v_keys, void* stream) {
  if (dtype != want || batch <= 0 || heads <= 0 || s <= 0 || (long long)batch * heads > 65535 || block_q <= 0 ||
      block_k < kTile || block_k % kTile != 0 || block_k > 65536 ||
      (pv_int8 != 0 && (sv == nullptr || v_keys < s || v_keys % kTile != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(pv_int8 != 0
                   ? launch<true, T>(q, k, v, sq, sk, sv, kv_len, out, batch, heads, s, block_q, block_k, v_keys, st)
                   : launch<false, T>(q, k, v, sq, sk, sv, kv_len, out, batch, heads, s, block_q, block_k, v_keys,
                                      st));
}

}  // namespace

// alg_flash_attention_int8_tc_d<D> (bf16) and alg_flash_attention_int8_tc_fp32_d<D> (fp32). dtype: the
// inputs' type, alg::kBFloat16 or alg::kFloat32 as the name says (the other returns cudaErrorInvalidValue).
// q, k: int8 codes [B·H, S, D]; v: [B·H, S, D] of that type (pv_int8 == 0) or V's int8 codes transposed,
// [B·H, D, v_keys], the keys of every 32-key chunk in the order of int8_pv_key_order and zero past S
// (pv_int8 != 0; v_keys a multiple of 64, at least S); sq: fp32 [B·H, ceil(S / block_q)] with scale·log2e
// folded in; sk: fp32 [B·H, ceil(S / block_k)]; sv: fp32 [B·H, D], read only when pv_int8 != 0; kv_len: null,
// or int32 [B] on the device (clamped to [0, S]); out: [B·H, S, D] of that type. All contiguous and 16-byte
// aligned. block_k must be a multiple of 64 and at most 65,536 (the int32 P·V sum of a key block). Returns
// the launch's cudaError_t.
extern "C" int ALG_CAT(alg_flash_attention_int8_tc_d, ALG_INT8_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* sq, const void* sk, const void* sv,
    const void* kv_len, void* out, int batch, int heads, int s, int block_q, int block_k, int pv_int8, int v_keys,
    void* stream) {
  return entry<bf16>(alg::kBFloat16, dtype, q, k, v, sq, sk, sv, kv_len, out, batch, heads, s, block_q, block_k,
                     pv_int8, v_keys, stream);
}

extern "C" int ALG_CAT(alg_flash_attention_int8_tc_fp32_d, ALG_INT8_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* sq, const void* sk, const void* sv,
    const void* kv_len, void* out, int batch, int heads, int s, int block_q, int block_k, int pv_int8, int v_keys,
    void* stream) {
  return entry<float>(alg::kFloat32, dtype, q, k, v, sq, sk, sv, kv_len, out, batch, heads, s, block_q, block_k,
                      pv_int8, v_keys, stream);
}
