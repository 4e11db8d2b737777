// Tile helpers shared by flash_attention_fwd.cu (K1f, float32) and
// flash_attention_bwd.cu (K1dq, K1dkv), and the column-mask policies of
// K1 and K6. The bf16 forward (K1f, K6f) is the Hopper kernel of
// flash_attention_fwd_sm90.cuh (wgmma, TMA, warp specialisation) and
// takes only the constants, row_off, pack_bf16, the quad reductions and
// the mask policies from here.
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
//
// bfloat16 backward (tensor cores, mma.sync): a block of 4 warps copies
// its bf16 tiles into shared memory with cp.async (rows padded to D + 8
// elements, so the ldmatrix rows hit distinct banks) and each warp owns
// 16 rows of the 64-row tile: mma.sync m16n8k16 with float32
// accumulators, fragments from ldmatrix (see mma_gemm.cuh). A result
// tile in accumulator layout (thread holds rows g and g + 8, columns
// 2 tig and 2 tig + 1 of each n8 tile, g = lane / 4, tig = lane % 4)
// becomes the A operand of the next product in registers, rounded to
// bf16 on the way, which is where the reference casts P and dS to the
// input dtype. Row reductions are two xor-shuffles over the 4 threads of
// a row. The backward has not moved to wgmma yet; the Hopper pieces of
// hopper.cuh are what it takes next.
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

// ---------------------------------------------------------------- mma

constexpr int MW = 4;          // warps per tensor-core block
constexpr int MT = MW * 32;    // its threads

// rows r0 .. r0 + 63 of head hh -> dst [64][D + 8] bf16 by cp.async
// (zero-filled past L); the caller commits and waits
template <int D>
__device__ __forceinline__ void async_rows(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int b, int L, int NH, int hh,
                                           int r0) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < TILE * CH; i += MT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * (D + 8) + c,
               ok ? src + row_off<D>(b, r0 + r, L, NH, hh) + c : src, ok);
  }
}

// A fragment (m16 x k16) at rows r0.., columns c0.. of a row-major tile
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int r0, int c0) {
  const int lane = threadIdx.x % 32, mi = lane / 8, ri = lane % 8;
  ldmatrix_x4(a, t + (r0 + (mi & 1) * 8 + ri) * LD + c0 + (mi >> 1) * 8);
}

// B fragments of the n8 tiles n0 and n0 + 8 over k0 .. k0 + 15, from a
// tile that holds B transposed (rows n, columns k: K in S = Q K^T)
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* t,
                                        int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                     ((lane >> 3) & 1) * 8);
}

// the same from a tile that holds B itself (rows k, columns n: V in P V)
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* t,
                                       int k0, int n0) {
  const int lane = threadIdx.x % 32, mi = lane / 8, ri = lane % 8;
  ldmatrix_x4_trans(b, t + (k0 + (mi & 1) * 8 + ri) * LD + n0 +
                           (mi >> 1) * 8);
}

// c0 += a b(n0), c1 += a b(n0 + 8)
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
  mma_16816(c0, a, b0);
  mma_16816(c1, a, b1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A operand (k 0..15) made of two accumulator tiles (k 0..7 in c0,
// k 8..15 in c1), rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
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

// row hr (0: g, 1: g + 8) of a warp's [16 x D] accumulators -> row l
template <int D>
__device__ __forceinline__ void store_acc_row(bf16* __restrict__ dst,
                                              const float (&acc)[D / 8][4],
                                              int hr, float mul, int b,
                                              int l, int L, int NH, int hh) {
  const int tig = threadIdx.x % 4;
  bf16* o = dst + row_off<D>(b, l, L, NH, hh) + 2 * tig;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) = __floats2bfloat162_rn(
        acc[nt][2 * hr] * mul, acc[nt][2 * hr + 1] * mul);
}

// shared memory of a tensor-core block: n_tiles [64][D + 8] bf16 tiles
// plus n_f 4-byte words
template <int D>
constexpr size_t mma_smem_bytes(int n_tiles, int n_f) {
  return sizeof(bf16) * (size_t)n_tiles * TILE * (D + 8) +
         sizeof(float) * (size_t)n_f;
}

// ---------------------------------------------------------------- masks
//
// The kernels of flash_attention_fwd.cuh / flash_attention_bwd.cuh take
// a column-mask policy. NoMask is K1's: every entry point below is a
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
