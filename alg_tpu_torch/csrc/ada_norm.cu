// The DiT blocks' AdaLN chain in one pass: gated residual, LayerNorm with fp32 statistics, modulation.
//
// Replaces no TPU kernel: XLA fused this chain on the TPU, and alg_tpu has no Pallas kernel for it. It was
// added because, as separate PyTorch ops, the chain moved about ten times the bytes it needs (a pass each for
// the cast, the mean, the subtraction, the square, the second mean, the normalisation, the affine, the cast
// back, 1 + scale, the product, the shift, the gate's product and sum, and the joint stream's concatenation):
// about 190-200 bytes an element a CogVideoX block, a sixth to a quarter of a DiT forward on the H100.
//
// For each row of d values of a batch element, one launch does, by the template's mode:
//   kAdd:   x' = x + g ⊙ o (kGate; else x + o), rounded as the plain ops round (g·o, then the sum), written
//           to x_out as the new residual; o is the branch output, read through its row stride from the joint
//           stream;
//   kNorm:  LayerNorm of x' (or x) with an fp32 mean and a two-pass fp32 variance, times the fp32 affine
//           (kAffine) and rounded to the activation type; then (kMod) · (1 + scale) + shift, rounded after
//           1 + scale, after the product and after the sum; written to y through its row stride.
// Every rounding is the plain composition's (ops/ada_norm.py:ada_norm_plain), in its order, with no fused
// multiply-add; only the order of the two row sums differs. fp32 inputs stay fp32 throughout.
//
// The rows come in up to two streams (CogVideoX: the text rows, then the video rows), each with its own
// residual, gate, scale and shift; o and y hold the streams' rows one after the other (text rows first), so
// the DiT's joint [B, T + S, d] input to the attention and to the MLP is written here, with no concatenation.
//
// Bound on the H100: bytes. At [2, 18002, 3072] bf16, a gate + norm launch reads x and o and writes x' and y,
// 8 bytes an element (885 MB, 0.26 ms at 3.35 TB/s); a norm launch 4 bytes, a gate launch 6. With the bytes cut
// to these, what holds a launch back is the instructions and barriers of a row against its bytes, so the
// design keeps both few.
//
// Design. A block owns whole rows, 8 values a thread (one 16-byte word in bf16, two in fp32), so a row is
// d/8 threads (d <= 5120) and never leaves registers between its load and its stores. The blocks are
// persistent: each takes one stream of one batch element and walks every n-th row of it, with the per-batch
// gate, 1 + scale and shift (packed, in T) and the fp32 affine loaded once into registers; the host sizes the
// grid to one wave of resident blocks, split between the streams by rows. The residual add and the modulation
// run on packed pairs (mul.rn / add.rn.bf16x2), two values an instruction; only the statistics and the norm
// run in fp32. A row's two sums take one barrier each (warp shuffles into a slot a warp, then every warp sums
// the slots by shuffles). In bf16 a row's words are loaded two rows ahead, so loads stay in flight across the
// barriers; rows of d <= 3072 take blocks of at most 384 threads held to 85 registers, two resident on an SM
// (measured on the H100: 87% of the bound for CogVideoX's gate + norm, against 78% with one block of 640).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kElems = 8;          // a thread's values of a row
constexpr int kWideThreads = 640;   // d <= 5120: one block of up to 102 registers a thread on an SM
constexpr int kNarrowThreads = 384; // bf16 rows of d <= 3072: two blocks an SM, up to 85 registers a thread
constexpr int kMaxStreams = 2;

// mode bits (ops/ada_norm.py builds the same)
constexpr int kAdd = 1, kGate = 2, kNorm = 4, kAffine = 8, kMod = 16;

// One stream of rows. Pointers are to T (x, x_out, gate, scale, shift); strides are in elements.
struct Stream {
  const void* x;      // residual: x + b·x_sb + r·x_sr
  void* x_out;        // new residual (kAdd), at x_out + b·xo_sb + r·xo_sr
  const void* gate;   // [B, d] rows at gate + b·gate_sb (kGate)
  const void* scale;  // (kMod)
  const void* shift;  // (kMod)
  long long x_sb, x_sr, xo_sb, xo_sr, gate_sb, scale_sb, shift_sb;
  long long rows;     // rows of the stream in a batch element
  long long row0;     // its first row in o and y
  long long blocks;   // blocks of a batch element (set by the host entry)
};

struct Args {
  Stream st[kMaxStreams];
  const void* o;         // branch output (kAdd): o + b·o_sb + (row0 + r)·o_sr
  const float* weight;   // [d] fp32 affine (kAffine)
  const float* bias;
  void* y;               // normed output (kNorm): y + b·y_sb + (row0 + r)·y_sr
  long long o_sb, o_sr, y_sb, y_sr;
  long long batch, d, n_streams;
  float eps;
};

// One correctly rounded product and sum of T on a 32-bit lane: two bf16 values (mul.rn / add.rn.bf16x2, one
// rounding of the exact result, as the plain ops' fp32 arithmetic and cast give for bf16 operands), or one
// fp32 value. The .rn forms are never contracted into a fused multiply-add.
template <typename T>
struct Lane;
template <>
struct Lane<float> {
  __device__ __forceinline__ static uint32_t mul(uint32_t a, uint32_t b) {
    return __float_as_uint(__fmul_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ __forceinline__ static uint32_t add(uint32_t a, uint32_t b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
};
template <>
struct Lane<__nv_bfloat16> {
  __device__ __forceinline__ static uint32_t mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ __forceinline__ static uint32_t add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
};

// kElems values of T as raw 16-byte words
template <typename T>
struct Words {
  using V = alg::Vec16<T>;
  static constexpr int kN = kElems / V::N;
  uint4 v[kN];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = *reinterpret_cast<const uint4*>(p + k * V::N);
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int k = 0; k < kN; ++k) *reinterpret_cast<uint4*>(p + k * V::N) = v[k];
  }
  __device__ __forceinline__ void unpack(float* out) const {
#pragma unroll
    for (int k = 0; k < kN; ++k) V::unpack(v[k], out + k * V::N);
  }
  __device__ __forceinline__ void pack(const float* in) {  // rounds to T
#pragma unroll
    for (int k = 0; k < kN; ++k) V::store(reinterpret_cast<T*>(&v[k]), in + k * V::N);
  }
  // this · b, and this + b, value by value, each rounded to T
  __device__ __forceinline__ Words mul(const Words& b) const {
    Words r;
#pragma unroll
    for (int k = 0; k < kN; ++k)
      r.v[k] = make_uint4(Lane<T>::mul(v[k].x, b.v[k].x), Lane<T>::mul(v[k].y, b.v[k].y),
                          Lane<T>::mul(v[k].z, b.v[k].z), Lane<T>::mul(v[k].w, b.v[k].w));
    return r;
  }
  __device__ __forceinline__ Words add(const Words& b) const {
    Words r;
#pragma unroll
    for (int k = 0; k < kN; ++k)
      r.v[k] = make_uint4(Lane<T>::add(v[k].x, b.v[k].x), Lane<T>::add(v[k].y, b.v[k].y),
                          Lane<T>::add(v[k].z, b.v[k].z), Lane<T>::add(v[k].w, b.v[k].w));
    return r;
  }
};

// Sum over the block: each warp's sum by xor shuffles into its slot; after the barrier every warp reads the
// slots a lane each and sums them by the same shuffles, so every thread holds the same total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* slots, int n_warps) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < n_warps ? slots[lane] : 0.0f);
}

// kMaxThreads: kWideThreads or kNarrowThreads (bf16 only). kAhead: rows whose loads are in flight ahead of the
// row in hand, two in bf16 (one in fp32, whose words take twice the registers).
template <typename T, int kMode, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads, kMaxThreads == kNarrowThreads ? 2 : 1)
    ada_norm_kernel(const Args a) {
  constexpr bool add = kMode & kAdd, gated = kMode & kGate, norm = kMode & kNorm, affine = kMode & kAffine,
                 mod = kMode & kMod;
  constexpr int kAhead = sizeof(T) == 2 ? 2 : 1;
  // Slot reuse is safe with one array a statistic: a thread reads row i's mean slot before it reaches row i's
  // variance barrier, which every writer of the next row's mean has passed (and likewise for the variance).
  __shared__ float slots[2][kMaxThreads / 32];

  // block -> (stream, batch element, block of the stream)
  long long blk = blockIdx.x;
  const bool second = a.n_streams > 1 && blk >= a.st[0].blocks * a.batch;
  if (second) blk -= a.st[0].blocks * a.batch;
  const Stream s = second ? a.st[1] : a.st[0];
  const long long b = blk / s.blocks, first = blk - b * s.blocks, step = s.blocks * kAhead;
  const int col = threadIdx.x * kElems;
  const bool active = col < a.d;  // the last warp's lanes past d join the reductions with zeros
  const int n_warps = blockDim.x >> 5;
  const float inv_d = 1.0f / (float)a.d;

  // the batch element's vectors, for every row this block takes
  float w[kElems], bb[kElems];
  Words<T> scale1, shift, gate;  // scale1: 1 + scale, rounded to T as the plain ops round it
  scale1.zero();
  shift.zero();
  gate.zero();
#pragma unroll
  for (int e = 0; e < kElems; ++e) w[e] = bb[e] = 0.0f;
  if (active) {
    if (affine) {
#pragma unroll
      for (int e = 0; e < kElems; e += 4) {
        alg::load4(a.weight + col + e, w + e);
        alg::load4(a.bias + col + e, bb + e);
      }
    }
    if (mod) {
      float one[kElems];
#pragma unroll
      for (int e = 0; e < kElems; ++e) one[e] = 1.0f;
      scale1.pack(one);
      Words<T> scale;
      scale.load(static_cast<const T*>(s.scale) + b * s.scale_sb + col);
      scale1 = scale1.add(scale);
      shift.load(static_cast<const T*>(s.shift) + b * s.shift_sb + col);
    }
    if (gated) gate.load(static_cast<const T*>(s.gate) + b * s.gate_sb + col);
  }

  const T* xp = static_cast<const T*>(s.x) + b * s.x_sb + col;
  const T* op = add ? static_cast<const T*>(a.o) + b * a.o_sb + s.row0 * a.o_sr + col : nullptr;
  T* xo = add ? static_cast<T*>(s.x_out) + b * s.xo_sb + col : nullptr;
  T* yp = norm ? static_cast<T*>(a.y) + b * a.y_sb + s.row0 * a.y_sr + col : nullptr;

  // the words of the block's next kAhead rows, each loaded kAhead rows before its use
  Words<T> xq[kAhead], oq[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const long long r = first + u * s.blocks;
    xq[u].zero();
    oq[u].zero();
    if (active && r < s.rows) {
      xq[u].load(xp + r * s.x_sr);
      if (add) oq[u].load(op + r * a.o_sr);
    }
  }
  for (long long r0 = first; r0 < s.rows; r0 += step) {  // the same rows for every thread of the block
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long r = r0 + u * s.blocks;
      if (r >= s.rows) break;
      Words<T> xw = xq[u];
      const Words<T> ow = oq[u];
      if (active && r + step < s.rows) {
        xq[u].load(xp + (r + step) * s.x_sr);
        if (add) oq[u].load(op + (r + step) * a.o_sr);
      }
      if (add) {
        xw = xw.add(gated ? gate.mul(ow) : ow);  // x + g·o: the product rounded, then the sum
        if (active) xw.store(xo + r * s.xo_sr);
      }
      if (norm) {
        float v[kElems];
        xw.unpack(v);
        float sum = 0.0f;
#pragma unroll
        for (int e = 0; e < kElems; ++e) sum += v[e];
        const float mean = block_sum(sum, slots[0], n_warps) * inv_d;
        float sq = 0.0f;
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          v[e] = __fsub_rn(v[e], mean);
          sq += v[e] * v[e];
        }
        const float rstd = rsqrtf(block_sum(active ? sq : 0.0f, slots[1], n_warps) * inv_d + a.eps);
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          v[e] = __fmul_rn(v[e], rstd);
          if (affine) v[e] = __fadd_rn(__fmul_rn(v[e], w[e]), bb[e]);
        }
        Words<T> y;
        y.pack(v);  // the norm rounded to T
        if (mod) y = y.mul(scale1).add(shift);  // · (1 + scale), rounded; + shift, rounded
        if (active) y.store(yp + r * a.y_sr);
      }
    }
  }
}

// Blocks a batch element for each stream: one wave of resident blocks split by rows, each stream with rows
// given at least one block and none more than rows, so that no block walks more than q rows.
void split_blocks(Args& a, long long resident) {
  const long long per_batch = resident / a.batch > 1 ? resident / a.batch : 1;
  long long rows = 0;
  for (int z = 0; z < a.n_streams; ++z) rows += a.st[z].rows;
  long long q = (rows + per_batch - 1) / per_batch;
  for (;; ++q) {
    long long n = 0;
    for (int z = 0; z < a.n_streams; ++z) n += (a.st[z].rows + q - 1) / q;
    if (n <= per_batch || q >= rows) break;
  }
  for (int z = 0; z < a.n_streams; ++z) a.st[z].blocks = (a.st[z].rows + q - 1) / q;
}

template <typename T, int kMode, int kMaxThreads>
cudaError_t launch_with(Args a, int threads, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ada_norm_kernel<T, kMode, kMaxThreads>, threads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  split_blocks(a, (long long)sms * per_sm);
  long long blocks = 0;
  for (int z = 0; z < a.n_streams; ++z) blocks += a.st[z].blocks * a.batch;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ada_norm_kernel<T, kMode, kMaxThreads><<<(unsigned)blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int threads = (int)((a.d / kElems + 31) / 32 * 32);
  if constexpr (sizeof(T) == 2) {
    if (threads <= kNarrowThreads) return launch_with<T, kMode, kNarrowThreads>(a, threads, stream);
  }
  return launch_with<T, kMode, kWideThreads>(a, threads, stream);
}

template <typename T>
cudaError_t dispatch(int mode, const Args& a, cudaStream_t stream) {
  switch (mode) {
#define ALG_ADA_NORM_MODE(m) \
  case (m):                  \
    return launch<T, (m)>(a, stream);
#define ALG_ADA_NORM_NORMS(m)                \
  ALG_ADA_NORM_MODE((m) | kNorm)             \
  ALG_ADA_NORM_MODE((m) | kNorm | kAffine)   \
  ALG_ADA_NORM_MODE((m) | kNorm | kMod)      \
  ALG_ADA_NORM_MODE((m) | kNorm | kAffine | kMod)
    ALG_ADA_NORM_NORMS(0)
    ALG_ADA_NORM_NORMS(kAdd)
    ALG_ADA_NORM_NORMS(kAdd | kGate)
    ALG_ADA_NORM_MODE(kAdd)
    ALG_ADA_NORM_MODE(kAdd | kGate)
#undef ALG_ADA_NORM_NORMS
#undef ALG_ADA_NORM_MODE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// args: a struct Args (ops/ada_norm.py mirrors it); the entry sets each stream's `blocks`. mode: kAdd, kGate,
// kNorm, kAffine, kMod bits (kGate needs kAdd; kAffine and kMod need kNorm; kAdd or kNorm). d: a multiple of 8,
// at most 5120; every row and vector 16-byte aligned with unit stride along d. Returns the launch's
// cudaError_t (0 on success).
extern "C" int alg_ada_norm(int dtype, int mode, const void* args, void* stream) {
  Args a = *static_cast<const Args*>(args);
  if (a.d < kElems || a.d % kElems != 0 || a.d > (long long)kElems * kWideThreads || a.batch < 1 ||
      a.n_streams < 1 || a.n_streams > kMaxStreams)
    return (int)cudaErrorInvalidValue;
  long long rows = 0;
  for (int z = 0; z < a.n_streams; ++z) {
    if (a.st[z].rows < 0) return (int)cudaErrorInvalidValue;
    rows += a.st[z].rows;
  }
  if (rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case alg::kFloat32:
      return (int)dispatch<float>(mode, a, st);
    case alg::kBFloat16:
      return (int)dispatch<__nv_bfloat16>(mode, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
