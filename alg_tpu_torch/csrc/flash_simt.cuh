// Register-tiled fp32 products on the CUDA cores for the fp32 attention
// kernels: the forward (flash_attention.cu), dQ and dK/dV
// (flash_attention_bwd.cu).
// No MMA instruction takes fp32 products, so these kernels stay on the FMA
// pipes; what bounds them is how many FMAs each shared-memory read feeds.
//
// Layout. A block has 128 threads, seen as 16 row groups of 8 lanes
// (ty = threadIdx.x / 8, tx = threadIdx.x % 8; a warp holds 4 row groups). In
// a product A·Bᵀ of a [16·TM, D] tile A and a [8·TN, D] tile B (both in
// shared memory), the thread (ty, tx) owns the TM × TN micro-tile of rows
// ty + 16 i and columns tx + 8 j. At each step of 4 along D it reads TM rows
// of A and TN rows of B as float4s and does 4·TM·TN FMAs: 8 FMAs per LDS.128
// at TM = TN = 4, 10.7 at 4 × 8, against 4 in a kernel whose thread holds one
// row and reads the other side a row at a time. In the second product (P·V,
// a [16·TM, N] tile P against an [N, D] tile V) the same thread owns the same
// TM rows and every 8th group of VW head-dim columns (group tx + 8 c), so
// that the output rows stay with the thread that holds their softmax state.
// The 8 lanes of a row group sit in one warp: a row's max or sum is three xor
// shuffles, and P passes from the first product to the second through shared
// memory with a __syncwarp.
//
// Banks. Rows of a [rows, D] tile are padded to D + 4 floats (16 bytes): the
// 4 row groups of a warp read 4 consecutive A rows, and the 8 lanes of a
// group 8 consecutive B rows, and at a row stride of 272, 336 or 528 bytes
// (D = 64, 80, 128) consecutive rows start in distinct 16-byte bank groups,
// where unpadded rows of 256 or 512 bytes would all fall on the same banks.
// P tiles are padded by 8 floats: a warp writes 4 rows × 8 consecutive
// floats, which at a stride of 32 mod 128 bytes fill 4 disjoint bank ranges.
//
// Tiles arrive from device memory by cp.async 16-byte copies straight into the
// padded rows (fp32 needs no conversion); rows at or past a limit are
// zero-filled with a source size of 0 (mma.cuh's cp_async16).
//
// Block heights. The forward and dQ kernels take 16·TM query rows a block;
// their launchers pick TM by one rule (rows_per_group): the largest blocks
// where those still give every SM a block, else 32 rows, else 16.
#pragma once

#include <stdint.h>

#include "mma.cuh"

namespace alg {
namespace simt {

constexpr int kThreads = 128;                 // threads a block
constexpr int kRowLanes = 8;                  // lanes of a row group
constexpr int kGroups = kThreads / kRowLanes;  // row groups a block

// Row strides, in floats, of a padded [rows, D] tile and of a padded [rows, n] P tile.
__host__ __device__ constexpr int stride(int d) { return d + 4; }
__host__ __device__ constexpr int p_stride(int n) { return n + 8; }

// Head-dim values a lane owns in the second product (D / 8), and the width of its reads: float4 where
// that divides them, else float2 (D = 80: 10 values, 5 float2).
template <int kD>
struct Cols {
  static constexpr int kN = kD / kRowLanes;
  static constexpr int kVec = kN % 4 == 0 ? 4 : 2;
  static constexpr int kGroupsPerLane = kN / kVec;
  static_assert(kD % (kRowLanes * 2) == 0, "head dim");
};

// Rows [r0, r0 + kRows) of a [.., kCols] fp32 matrix at src into the padded tile at dst, by cp.async
// copies of the block's threads; rows at or past `limit` are zero-filled without being read.
template <int kRows, int kCols>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int r0, int limit) {
  constexpr int kChunks = kCols / 4;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < limit;
    mma::cp_async16(mma::smem_addr(dst + r * stride(kCols) + 4 * c),
                    ok ? src + (long long)(r0 + r) * kCols + 4 * c : src, ok);
  }
}

// Elements [r0, r0 + kN) of an fp32 vector into dst, zero past `limit`.
template <int kN>
__device__ __forceinline__ void stage_vector(float* dst, const float* __restrict__ src, int r0, int limit) {
  for (int i = threadIdx.x; i < kN; i += kThreads) {
    const bool ok = r0 + i < limit;
    mma::cp_async4(mma::smem_addr(dst + i), ok ? src + r0 + i : src, ok);
  }
}

// acc[i][j] += A[ty + 16 i] · B[tx + 8 j] over kD: a points at row ty of the padded A tile, b at row tx
// of the padded B tile. Each sum runs over d in ascending order.
template <int TM, int TN, int kD>
__device__ __forceinline__ void dot_tile(float (&acc)[TM][TN], const float* a, const float* b) {
  constexpr int S = stride(kD);
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * kGroups * S + d);
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = *reinterpret_cast<const float4*>(b + j * kRowLanes * S + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][c·kVec + e] += Σ_{n < kN} P[ty + 16 i][n] · V[n][(tx + 8 c)·kVec + e]: p points at row ty of the
// padded [16·TM, kN] P tile, v at column tx·kVec of row 0 of the padded [kN, kD] V tile. Each sum runs
// over n in ascending order.
template <int TM, int kN, int kD>
__device__ __forceinline__ void pv_tile(float (&acc)[TM][kD / kRowLanes], const float* p, const float* v) {
  using C = Cols<kD>;
  constexpr int PS = p_stride(kN), S = stride(kD);
#pragma unroll 2
  for (int n = 0; n < kN; n += 4) {
    float4 pr[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) pr[i] = *reinterpret_cast<const float4*>(p + i * kGroups * PS + n);
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      float vv[C::kN];
#pragma unroll
      for (int c = 0; c < C::kGroupsPerLane; ++c) {
        const float* at = v + (n + nn) * S + c * kRowLanes * C::kVec;
        if constexpr (C::kVec == 4) {
          const float4 x = *reinterpret_cast<const float4*>(at);
          vv[4 * c] = x.x; vv[4 * c + 1] = x.y; vv[4 * c + 2] = x.z; vv[4 * c + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(at);
          vv[2 * c] = x.x; vv[2 * c + 1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float pe = nn == 0 ? pr[i].x : nn == 1 ? pr[i].y : nn == 2 ? pr[i].z : pr[i].w;
#pragma unroll
        for (int e = 0; e < C::kN; ++e) acc[i][e] = fmaf(pe, vv[e], acc[i][e]);
      }
    }
  }
}

// The SMs of the current device, read once a device (host code).
inline cudaError_t multiprocessors(int* n) {
  static int count[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && count[device] > 0) {
    *n = count[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < 64) count[device] = *n;
  return err;
}

// TM for a call over `bh` heads of `sq` query rows (host code): tm_large where 16·tm_large-row blocks give
// every SM of the device a block, else 2 where 32-row blocks do, else 1.
inline cudaError_t rows_per_group(int sq, long long bh, int tm_large, int* tm) {
  int sms = 0;
  const cudaError_t err = multiprocessors(&sms);
  if (err != cudaSuccess) return err;
  auto blocks = [&](int t) { return (sq + kGroups * t - 1) / (kGroups * t) * bh; };
  *tm = blocks(tm_large) >= sms ? tm_large : blocks(2) >= sms ? 2 : 1;
  return cudaSuccess;
}

// Head-dim column of a lane's value e in the second product's layout.
template <int kD>
__device__ __forceinline__ int column(int tx, int e) {
  using C = Cols<kD>;
  return (tx + kRowLanes * (e / C::kVec)) * C::kVec + e % C::kVec;
}

}  // namespace simt
}  // namespace alg
