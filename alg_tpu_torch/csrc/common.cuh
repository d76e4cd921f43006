// Element-type helpers shared by the port's kernels.
//
// Kernels are templated on the activation type T (float for fp32 parity
// runs, __nv_bfloat16 for the bf16 main path). Arithmetic always runs in
// fp32; these helpers convert on load and round once on store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace alg {

// C-interface dtype codes (mirrored by the Python wrappers).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an fp32 value to T and back: the value a T tensor would hold.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// Two consecutive elements, loaded and stored as one 4- or 8-byte access.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Four consecutive elements, loaded and stored as one 16- or 8-byte access.
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// 16 bytes of T as fp32 values: 4 floats or 8 bf16 values. `unpack` converts a raw 16-byte load, `load`
// loads and converts, `store` rounds N values to T and writes them as one 16-byte store.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

}  // namespace alg
