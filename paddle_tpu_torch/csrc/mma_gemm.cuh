// The bfloat16 mma.sync pieces of moe_gmm.cu's serving body (its K4 / K5
// forward modes below SM90_MIN_ROWS rows a group): the m16n8k16 product
// (bf16 inputs, float32 accumulation), ldmatrix fragments, cp.async
// copies, the warp layout of a [BM x 128] tile of 4 warps and its store
// index. The bf16 type and unpack8 serve the Hopper headers too.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ptt {

constexpr int MMA_BN = 128;
constexpr int MMA_BK = 64;
constexpr int MMA_THREADS = 128;
constexpr int MMA_STAGES = 3;        // W ring depth
constexpr int MMA_LDA = MMA_BK + 8;  // padded rows of the shared tiles
constexpr int MMA_LDB = MMA_BN + 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of two adjacent n8 tiles (k 0..15 of the slice) from a
// row-major [k][n] shared tile: lanes 0-7 / 8-15 / 16-23 / 24-31 give
// the rows of matrices (k0-7, n0), (k8-15, n0), (k0-7, n0+8),
// (k8-15, n0+8); .trans hands each thread the (2 tig, 2 tig + 1; g)
// pair the mma B operand wants.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16-byte global -> shared copy, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(h[e]);
}

// Warp layout of a [BM x MMA_BN] tile: 2 x 2 warps of 32 x 64 for
// BM = 64, 1 x 4 warps of BM x 32 for BM = 16 and 48.
template <int BM>
struct WarpTile {
  static constexpr int WARPS_M = BM % 32 == 0 ? 2 : 1;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = MMA_BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
};

// A fragment of one m16 tile (k 0..15 of the slice) from a row-major
// [m][k] shared tile: lanes 0-7 / 8-15 / 16-23 / 24-31 give the rows of
// (m0-7, k0-7), (m8-15, k0-7), (m0-7, k8-15), (m8-15, k8-15), which are
// the mma A registers a0..a3 in order.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Element e (0..3) of acc[mt][nt] sits at tile row wm*WM + mt*16 + g
// (+8 for e >= 2) and column wn*WN + nt*8 + tig*2 + (e & 1).
template <int BM>
__device__ __forceinline__ void mma_store_index(int mt, int nt, int e,
                                                int& row, int& col) {
  using WT = WarpTile<BM>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / WT::WARPS_N, wn = warp % WT::WARPS_N;
  row = wm * WT::WM + mt * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
  col = wn * WT::WN + nt * 8 + (lane & 3) * 2 + (e & 1);
}

}  // namespace ptt
