// Tensor-core building blocks in inline PTX for the attention kernels
// (flash_attention_tc.cu, flash_attention_bwd_tc.cu, flash_attention_bwd_dq_tc.cu,
// flash_attention_int8_tc.cu): warp-wide matrix products mma.sync.m16n8k16
// with bf16 inputs and fp32 accumulators and m16n8k32 with int8 inputs and
// int32 accumulators, the ldmatrix loads that fill their fragments from
// shared memory, cp.async copies from device memory into shared memory, and
// the layout of a [rows, D] bf16 tile in shared memory that keeps the
// ldmatrix reads free of bank conflicts (an int8 row of D values is a row of
// D / 2 b16 units).
//
// Fragments of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for
// lane l, g = l / 4 and c = 2 * (l % 4):
//   A (16 x 16, row-major): a0 = A[g][c..c+1],  a1 = A[g+8][c..c+1],
//                           a2 = A[g][c+8..c+9], a3 = A[g+8][c+8..c+9]
//   B (16 x 8, "col"):      b0 = B[c..c+1][g],  b1 = B[c+8..c+9][g]
//   C (16 x 8, fp32):       c0, c1 = C[g][c..c+1],  c2, c3 = C[g+8][c..c+1]
// Each 32-bit register holds two bf16, the lower index in the lower half.
// The C fragment of two neighbouring n8 tiles is therefore, as bf16 pairs,
// exactly the A fragment of the m16k16 block they form: the accumulator of
// one product feeds the next without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace alg {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two fp32 values rounded to bf16 (to nearest even) in one register, a in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += a · b over one m16n8k16 tile, bf16 inputs, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b over one m16n8k32 tile, int8 inputs, exact int32 accumulation. Its fragments hold four int8
// values a register, the lowest index in the lowest byte; for lane l, g = l / 4 and t = l % 4:
//   A (16 x 32, row-major): a0 = A[g][4t..4t+3],  a1 = A[g+8][4t..4t+3],
//                           a2 = A[g][16+4t..16+4t+3], a3 = A[g+8][16+4t..16+4t+3]
//   B (32 x 8, "col"):      b0 = B[4t..4t+3][g],  b1 = B[16+4t..16+4t+3][g]
//   C (16 x 8, s32):        the layout of the fp32 C fragment of m16n8k16.
// A 16-byte row chunk of int8 values is 8 b16 units, so the b16 ldmatrix below fills these fragments
// unchanged: a0-a3 from a 16-row, 32-byte block in "A order", b0 and b1 from the two 16-byte chunks of 8
// rows of a matrix stored N-major.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices from shared memory: lanes 8i..8i+7 give the row addresses of matrix i, and
// lane l receives, of matrix i, row l / 4 and columns 2 (l % 4), +1 in r[i] (with .trans the transpose:
// column l / 4, rows 2 (l % 4), +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes from device to shared memory, bypassing L1. With valid false the source size is 0: the 16
// bytes are zero-filled and nothing is read (src must still be a device address; callers pass the
// tensor's base).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, zero-filled when not valid (per-row fp32 values with no alignment beyond their own).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most n of this thread's committed groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// A [rows, kD] bf16 tile in shared memory, row by row in 16-byte chunks (8 values). ldmatrix reads one
// chunk from each of 8 consecutive rows at a time; with rows of 128 or 256 bytes those chunks would all
// sit in the same 4 of the 32 banks. So chunk c of row r is stored at chunk position c ^ (r % 8) of its
// row (an XOR swizzle: 8 consecutive rows put a logical chunk in 8 different bank groups). A row of
// D = 80 has 10 chunks, which an XOR over 3 bits cannot keep inside the row, so it is padded to 11
// chunks instead (176 bytes: 8 consecutive rows again start in 8 different bank groups).
template <int kD>
struct Tile {
  static constexpr int kChunks = kD / 8;
  static constexpr bool kSwizzle = kChunks % 8 == 0;
  static constexpr int kRowBytes = kSwizzle ? 2 * kD : 2 * kD + 16;
  static constexpr int bytes(int rows) { return rows * kRowBytes; }
  __device__ __forceinline__ static uint32_t offset(int row, int chunk) {
    return row * kRowBytes + 16 * (kSwizzle ? (chunk ^ (row & 7)) : chunk);
  }
  // Rows [r0, r0 + kRows) of a [.., kD] bf16 matrix at src into the tile at dst, by kThreads threads,
  // as cp.async copies; rows at or past `limit` are zero-filled without being read.
  template <int kRows, int kThreads>
  __device__ __forceinline__ static void stage(uint32_t dst, const __nv_bfloat16* src, int r0, int limit) {
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = r0 + r < limit;
      cp_async16(dst + offset(r, c), ok ? src + (long long)(r0 + r) * kD + 8 * c : src, ok);
    }
  }
};

// Lane addresses for ldmatrix_x4 over a 16 x 16 block at (row0, chunk0) of a Tile, in the two orders
// the kernels need. "A order" gives {rows 0-7, rows 8-15} x {chunk0, chunk0 + 1}, column-major over the
// four matrices: an A fragment (rows = M, chunks = K) read plainly, or with .trans the B fragments of two
// n8 tiles of a matrix stored K-major (rows = K, chunks = N): r = {b0, b1} of chunk0, {b0, b1} of
// chunk0 + 1. "B order" gives {chunk0, chunk0 + 1} of rows 0-7, then of rows 8-15: the B fragments of
// two n8 tiles of a matrix stored N-major (rows = N, chunks = K), read plainly: r = {b0, b1} of rows
// 0-7, {b0, b1} of rows 8-15.
template <int kD>
__device__ __forceinline__ uint32_t a_order(uint32_t base, int row0, int chunk0, int lane) {
  return base + Tile<kD>::offset(row0 + (lane & 15), chunk0 + (lane >> 4));
}
template <int kD>
__device__ __forceinline__ uint32_t b_order(uint32_t base, int row0, int chunk0, int lane) {
  return base + Tile<kD>::offset(row0 + (lane & 7) + ((lane >> 4) << 3), chunk0 + ((lane >> 3) & 1));
}

}  // namespace mma
}  // namespace alg
