// Shared device helpers of the port's kernels: conversions between the
// storage types (float, bf16, int8 with a scale) and the float32 the
// kernels compute in, 16-byte vector loads, and warp reductions. dtype
// codes passed from Python: 0 = float32, 1 = bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace ptt {

constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as PyTorch casts
}

// round a float32 value through the storage type T (identity for float)
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

// 16 bytes of T at src (16-byte aligned) into float32 dst: 4 floats or 8
// bfloat16 values
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst);
template <>
__device__ __forceinline__ void load_vec<float>(const float* src,
                                                float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16>(
    const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(h[e]);
}

// four consecutive elements of a KV pool row held in registers between
// their load and their use: float32 pools as 16 bytes; int8 pools as 4
// bytes and the row's scale, dequantized as the reference does (int8 ->
// float32, times the scale)
template <typename KV>
struct Kv4;
template <>
struct Kv4<float> {
  uint4 raw;
  // p: the elements (16-byte aligned); the scale row is not read
  __device__ __forceinline__ void load(const float* p, const float*,
                                       size_t) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void to_f(float* dst) const {
    dst[0] = __uint_as_float(raw.x); dst[1] = __uint_as_float(raw.y);
    dst[2] = __uint_as_float(raw.z); dst[3] = __uint_as_float(raw.w);
  }
};
template <>
struct Kv4<int8_t> {
  uint32_t raw;
  float s;
  // p: the elements (4-byte aligned); scale[row]: their row's scale
  __device__ __forceinline__ void load(const int8_t* p, const float* scale,
                                       size_t row) {
    raw = *reinterpret_cast<const uint32_t*>(p);
    s = scale[row];
  }
  __device__ __forceinline__ void to_f(float* dst) const {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[e] = (float)(int8_t)((raw >> (8 * e)) & 0xff) * s;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// the tree mode of the paged attention kernels: window row t's ancestor
// mask (bit j - 1: window node j), passed by value as a kernel argument
struct TreeBits {
  uint32_t bits[32];
};

}  // namespace ptt
