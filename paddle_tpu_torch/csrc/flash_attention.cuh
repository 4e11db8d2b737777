// Tile helpers shared by the float32 kernels of flash_attention_fwd.cuh
// (K1f) and flash_attention_bwd.cuh (K1dq, K1dkv), and the column-mask
// policies of K1 and K6. The bf16 kernels (K1f / K6f in
// flash_attention_fwd_sm90.cuh, K1dq / K1dkv / K6dq / K6dkv in
// flash_attention_bwd_sm90.cuh: wgmma, TMA, warp specialisation) take
// only the constants, row_off, pack_bf16, the quad reductions and the
// mask policies from here.
//
// Every kernel here works on 64-row tiles of the [B, L, heads, D]
// tensors the port passes (Paddle's flash-attention layout: a head's
// rows are D contiguous elements, H * D apart).
//
// float32 (CUDA cores): a block of 256 threads stages its tiles in
// shared memory as float32, rows padded to D + 1 floats so the column
// reads of the products below hit distinct banks. Thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty + 16 r (r < 4) and columns tx + 16 c
// of each 64-wide result; the 16 threads of a row sit in one half-warp,
// so row reductions are four xor-shuffles. Products run as float32
// fused multiply-adds.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma_gemm.cuh"

namespace ptt {
namespace fa {

constexpr int TILE = 64;      // rows of every q and kv tile
constexpr int NT = 256;       // threads per float32 block
constexpr int PP = TILE + 1;  // padded row of a [64 x 64] P / dS tile
constexpr float NEG_INF = -1e30f;

// offset of row l of head hh of batch b in a [B, L, NH, D] tensor
template <int D>
__device__ __forceinline__ size_t row_off(int b, int l, int L, int NH,
                                          int hh) {
  return (((size_t)b * L + l) * NH + hh) * D;
}

// rows r0 .. r0 + 63 of head hh -> dst [64][D + 1] float; zero past L
template <int D>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int b, int L, int NH, int hh,
                                           int r0) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < TILE * CH; i += NT) {
    const int r = i / CH, d = (i % CH) * 4;
    const float4 f =
        r0 + r < L
            ? *reinterpret_cast<const float4*>(
                  src + row_off<D>(b, r0 + r, L, NH, hh) + d)
            : make_float4(0.f, 0.f, 0.f, 0.f);
    float* o = dst + r * (D + 1) + d;
    o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
  }
}

// acc[r][c] = sum_d A[ty + 16 r][d] * B[tx + 16 c][d]; A, B [64][D + 1]
template <int D>
__device__ __forceinline__ void dot_rows(const float* A, const float* B,
                                         float (&acc)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// acc[r][c] += sum_j P[ty + 16 r][j] * V[j][tx + 16 c] (c < D / 16);
// P [64][65], V [64][D + 1]
template <int D>
__device__ __forceinline__ void acc_pv(const float* P, const float* V,
                                       float (&acc)[4][D / 16]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int j = 0; j < TILE; ++j) {
    float p[4], v[D / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) p[r] = P[(ty + 16 * r) * PP + j];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) v[c] = V[j * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(p[r], v[c], acc[r][c]);
  }
}

// reductions over the 16 threads of a row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

// row r of a thread's [4][D / 16] accumulator -> row l of head hh
template <int D>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&acc)[D / 16],
                                          float mul, int b, int l, int L,
                                          int NH, int hh) {
  const int tx = threadIdx.x % 16;
  float* o = dst + row_off<D>(b, l, L, NH, hh);
#pragma unroll
  for (int c = 0; c < D / 16; ++c) o[tx + 16 * c] = acc[c] * mul;
}

// shared memory of one block: n_rows tiles [64][D + 1] + n_p tiles
// [64][65], float32
template <int D>
constexpr size_t smem_bytes(int n_rows, int n_p) {
  return sizeof(float) * ((size_t)n_rows * TILE * (D + 1) +
                          (size_t)n_p * TILE * PP);
}

// ---------------------------------------------------------------- bf16

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// reductions over the 4 threads of an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}

// ---------------------------------------------------------------- masks
//
// The kernels of flash_attention_{fwd,bwd}.cuh and of their _sm90
// headers take a column-mask policy. NoMask is K1's: every entry point below is a
// constant, so K1 compiles to the kernels it had before masks existed.
// ColumnMask (flashmask.cuh) is K6's FlashMask mask: it narrows the
// walks to the live tiles (live bits, dead q-tile ranges) and adds
// sees() to each entry's predicate.
struct NoMask {
  static constexpr bool kOn = false;
  static constexpr int kBoundInts = 0;   // staged bounds of one kv tile
  __host__ __device__ int live_words() const { return 0; }
  __host__ __device__ int dead_ints(int) const { return 0; }
  __device__ int row(int, int, int) const { return 0; }
  template <int S = 1>
  __device__ void init_live(unsigned*, int, int, int, int) const {}
  __device__ int next_live(const unsigned*, int t, int) const { return t; }
  template <int S = 1>
  __device__ void init_dead(int*, int, int, int, int, int, int) const {}
  __device__ int next_item(const int*, int u, int, int, int) const {
    return u;
  }
  __device__ void stage(int*, int, int) const {}
  template <int W>
  __device__ bool load_bounds(int*, int, int, int, int) const {
    return false;
  }
  template <int W = TILE>
  __device__ bool sees(const int*, int, int) const { return true; }
};

}  // namespace fa
}  // namespace ptt
