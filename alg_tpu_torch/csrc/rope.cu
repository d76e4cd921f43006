// Interleaved-pair RoPE over [B, H, S, D]: out = x·cos + rot(x)·sin with
// rot(x0, x1) = (-x1, x0) on each adjacent pair.
//
// Replaces the TPU kernel alg_tpu/ops/qk_prep.py:_rope_kernel (Wan's q and
// k: the RMS norm there runs over the full inner dim before the head split,
// so only the rotation is left to fuse). The fp32 tables [S, D] are rounded
// to the activation type before use, as the reference casts them; the
// rotation runs in fp32 and rounds once on store.
//
// Bound on the H100: bytes. One read and one write of x (2 x 629 MB at the
// [3,40,32760,128] bf16 shape) plus one read of the fp32 cos/sin tables
// (33.5 MB at S = 32,760, D = 128).
//
// Design. The tables are shared by all B·H heads, and at the shipped lengths
// they are too large to stay in the 50 MB L2 beside the stream of x, so a
// grid that walks every table row once per head reads them from device
// memory B·H times (80 × 33.5 MB at Wan's [2,40,32760,128]: three times the
// bytes of x). Here a block takes one tile of S and one chunk of at most
// kMaxChunk heads, and the chunks of a tile are neighbouring blocks of the
// grid, which the card runs at about the same time: the first to arrive reads
// the tile's table rows from device memory and the others find them in L2,
// so the tables cross from device memory once a launch. A thread owns 16
// bytes of one row s (eight bf16 or four fp32 values: four or two whole
// pairs, so the rotation needs no shuffle): it reads that slot of the tables,
// rounds it to T and keeps it in registers, then walks the heads of its
// chunk, kHeadsInFlight at a time (their 16-byte loads all issued before the
// first is used), writing each head's rotated slot with one 16-byte store.
// Short chunks keep the blocks short, so that the last wave of the grid
// leaves little of the card idle at any S.
//
// The input is read through its strides (unit stride along D): the models
// hand over the [B, S, H, D] projection viewed as [B, H, S, D], and reading
// that view directly saves the separate transposing copy. The output is
// written contiguous. Any S >= 1; D a multiple of 8.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 8;       // heads a block walks, at most
constexpr int kHeadsInFlight = 4;  // loads a thread issues before it uses the first

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, long long stride_b, long long stride_h, long long stride_s,
            const float* __restrict__ cos_t, const float* __restrict__ sin_t, T* __restrict__ out,
            int heads, int n_heads, int n_chunks, int chunk, int seq, int head_dim) {
  using V = alg::Vec16<T>;
  constexpr int kVec = V::N;
  // block (S tile, chunk), chunks fastest; a tile covers kThreads of the S·D/kVec slots of a head, so the
  // per-thread index arithmetic stays in 32 bits
  const int s_tile = blockIdx.x / n_chunks, first = (blockIdx.x - s_tile * n_chunks) * chunk;
  const int vecs_per_row = head_dim / kVec;
  const int i = s_tile * kThreads + threadIdx.x;
  if (i >= seq * vecs_per_row) return;
  const int s = i / vecs_per_row;
  const int c = (i - s * vecs_per_row) * kVec;

  // this slot of the tables, rounded to T, for every head of the chunk
  float cs[kVec], sn[kVec];
#pragma unroll
  for (int e = 0; e < kVec; e += 4) {
    alg::load4(cos_t + s * head_dim + c + e, cs + e);
    alg::load4(sin_t + s * head_dim + c + e, sn + e);
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    cs[e] = alg::round_to<T>(cs[e]);
    sn[e] = alg::round_to<T>(sn[e]);
  }

  const long long x_at = s * stride_s + c;                    // the slot in head (0, 0) of x
  T* const o_at = out + (long long)s * head_dim + c;          // and of out, whose heads are S·D apart
  const long long o_head = (long long)seq * head_dim;
  const int bh_end = min(n_heads, first + chunk);
  for (int bh = first; bh < bh_end; bh += kHeadsInFlight) {
    uint4 raw[kHeadsInFlight];
#pragma unroll
    for (int u = 0; u < kHeadsInFlight; ++u) {
      if (bh + u < bh_end) {
        const int b = (bh + u) / heads, h = (bh + u) - b * heads;
        raw[u] = *reinterpret_cast<const uint4*>(x + b * stride_b + h * stride_h + x_at);
      }
    }
#pragma unroll
    for (int u = 0; u < kHeadsInFlight; ++u) {
      if (bh + u < bh_end) {
        float xv[kVec], o[kVec];
        V::unpack(raw[u], xv);
#pragma unroll
        for (int e = 0; e < kVec; e += 2) {
          o[e] = xv[e] * cs[e] - xv[e + 1] * sn[e];
          o[e + 1] = xv[e + 1] * cs[e + 1] + xv[e] * sn[e + 1];
        }
        V::store(o_at + (bh + u) * o_head, o);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, long long stride_b, long long stride_h, long long stride_s,
                   const void* cos_t, const void* sin_t, void* out, long long n_heads, int heads,
                   int seq, int head_dim, cudaStream_t stream) {
  constexpr int kVec = alg::Vec16<T>::N;
  if (head_dim % kVec != 0 || stride_b % kVec != 0 || stride_h % kVec != 0 || stride_s % kVec != 0)
    return cudaErrorInvalidValue;
  const long long vecs_per_head = (long long)seq * (head_dim / kVec);
  if (vecs_per_head > 0x7fffffffLL - kThreads || n_heads > 0x7fffffffLL - kHeadsInFlight)
    return cudaErrorInvalidValue;
  const long long s_tiles = (vecs_per_head + kThreads - 1) / kThreads;
  // the heads in as few chunks of at most kMaxChunk as there can be, all but the last of one size
  const long long n_chunks = (n_heads + kMaxChunk - 1) / kMaxChunk;
  const long long chunk = (n_heads + n_chunks - 1) / n_chunks;
  if (s_tiles * n_chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rope_kernel<T><<<(unsigned)(s_tiles * n_chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), stride_b, stride_h, stride_s, static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(out), heads, (int)n_heads, (int)n_chunks, (int)chunk, seq,
      head_dim);
  return cudaGetLastError();
}

}  // namespace

// x: [B, H, S, D] of `dtype` with element (b, h, s, d) at
// b·stride_b + h·stride_h + s·stride_s + d (strides in elements, multiples
// of 16 bytes); out: the same shape, contiguous; cos/sin: [S, D] fp32,
// contiguous. rows = B·H·S, with B·H, S·D < 2^31 - 256. Returns the
// launch's cudaError_t (0 on success).
extern "C" int alg_rope_interleaved(int dtype, const void* x, long long stride_b,
                                    long long stride_h, long long stride_s, const void* cos_t,
                                    const void* sin_t, void* out, long long rows, int heads,
                                    int seq, int head_dim, void* stream) {
  if (rows <= 0 || heads <= 0 || seq <= 0 || head_dim <= 0 || rows % ((long long)heads * seq) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_heads = rows / seq;
  switch (dtype) {
    case alg::kFloat32:
      return (int)launch<float>(x, stride_b, stride_h, stride_s, cos_t, sin_t, out, n_heads, heads, seq,
                                head_dim, st);
    case alg::kBFloat16:
      return (int)launch<__nv_bfloat16>(x, stride_b, stride_h, stride_s, cos_t, sin_t, out, n_heads, heads,
                                        seq, head_dim, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
