// The tiled product shared by norm_matmul.cu and matmul_residual.cu:
// one thread block computes a [BM x 64] tile of A @ W, where A [R, K]
// is produced element by element by the caller's loader (so a norm or
// an activation is applied as the tile is staged, and the activated A
// never exists in device memory) and W [K, N] is read from device
// memory in the storage type (TRANS_W: W is stored [N, K], and the tile
// contracts its last dim). Both tiles are staged in shared memory as
// float32 and contracted with fused multiply-adds: 256 threads, each
// owning BM/16 rows x 4 columns of the tile, accumulating in float32.
#pragma once

#include "common.cuh"

namespace ptt {

constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 16;
constexpr int GEMM_THREADS = 256;

template <typename T, int BM, bool TRANS_W = false, typename ALoad>
__device__ __forceinline__ void gemm_tile(const ALoad& load_a,
                                          const T* __restrict__ w, int R,
                                          int K, int N, int row0, int col0,
                                          float (&acc)[BM / 16][4]) {
  constexpr int TM = BM / 16;
  __shared__ float As[GEMM_BK][BM + 4];
  __shared__ float Ws[GEMM_BK][GEMM_BN + (TRANS_W ? 1 : 0)];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    for (int i = tid; i < BM * GEMM_BK; i += GEMM_THREADS) {
      const int m = i / GEMM_BK, kk = i % GEMM_BK;
      const int r = row0 + m, k = k0 + kk;
      As[kk][m] = (r < R && k < K) ? load_a(r, k, m) : 0.f;
    }
    for (int i = tid; i < GEMM_BK * GEMM_BN; i += GEMM_THREADS) {
      // TRANS_W: neighbouring threads read neighbouring k of one row
      const int kk = TRANS_W ? i % GEMM_BK : i / GEMM_BN;
      const int c = TRANS_W ? i / GEMM_BK : i % GEMM_BN;
      const int k = k0 + kk, col = col0 + c;
      const size_t at = TRANS_W ? (size_t)col * K + k : (size_t)k * N + col;
      Ws[kk][c] = (k < K && col < N) ? to_f<T>(w[at]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace ptt
