// The flash attention forward with the row log-sum-exp, under a column
// mask policy (flash_attention.cuh): K1f (NoMask, flash_attention_fwd.cu)
// and K6f (ColumnMask, flashmask_fwd.cu).
//
// o = softmax(scale * Q K^T + mask) V over [B, L, H, D] (GQA: kv head
// h / (H / Hkv)).
//
// What bounds it on the H100: operations. A causal pass does
// 2 * B * H * L^2 * D multiply-adds (two products over half the square),
// which at L = 4096 is ~2000 flops per byte of Q, K, V and O, far above
// the card's ~295 flops per byte; the least time is those flops at the
// dense bf16 tensor-core rate. Under a FlashMask mask only the visible
// pairs count, and the skipped tiles are what keeps the kernel near
// them.
//
// Contract of both dtypes: the block walks the live kv tiles of its kv
// head (under causal, only up to the tile that holds the diagonal, as
// the TPU kernels' `live` predicate skips the tiles above it; under a
// column mask, also not the tiles that mask every row of the q tile),
// with an online softmax whose state (m, l) and output accumulator stay
// in float32 registers; it ends with acc / l and the natural-log lse
// (NEG_INF for a row that saw no column), as the TPU kernels' _finish
// does. l sums the unrounded P. Columns past Lk and rows past Lq are
// masked, so any L works; causal is top-left (column j visible to row i
// iff j <= i). A masked entry is set to exactly NEG_INF and its P to
// exactly 0 (the guard the TPU kernel writes as s <= NEG_INF / 2), so a
// row that sees nothing ends with o = 0 and lse = NEG_INF.
//
// bfloat16 runs the Hopper kernel of flash_attention_fwd_sm90.cuh:
// wgmma at the tensor cores' full rate, a TMA ring fed by a producer
// warpgroup while two consumer warpgroups multiply and exponentiate,
// the per-entry mask only on the tiles that need it, the heaviest q
// tiles first. float32 runs on the CUDA cores here (256 threads, each
// scoring a 4 x 4 part of the 64 x 64 tile from float32 shared-memory
// tiles), since the tensor cores' TF32 would not hold float32 to the
// reference; it stays well above its bound.
#pragma once

#include "flash_attention.cuh"
#include "flash_attention_fwd_sm90.cuh"

namespace ptt {
namespace fa {

// float32 on the CUDA cores
template <int D, class Mask>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int Lq, int Lk, int H, int Hkv,
               float scale, int causal, Mask mask) {
  constexpr int DP = D + 1, DC = D / 16;
  const int q0 = blockIdx.x * TILE, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * DP;
  float* Vs = Ks + TILE * DP;
  float* Ps = Vs + TILE * DP;
  unsigned* live = reinterpret_cast<unsigned*>(Ps + TILE * PP);
  int* bs = reinterpret_cast<int*>(live + mask.live_words());

  const int q_last = min(q0 + TILE, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  const int n_kt = (k_end + TILE - 1) / TILE;
  const int mrow = mask.row(b, h, H);
  stage_rows<D>(Qs, q, b, Lq, H, h, q0);
  mask.init_live(live, mrow, n_kt, q0, q_last);
  if (Mask::kOn) __syncthreads();
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  for (int t = mask.next_live(live, 0, n_kt); t < n_kt;
       t = mask.next_live(live, t + 1, n_kt)) {
    const int k0 = t * TILE;
    __syncthreads();  // Q staged; the previous K, V, P and bounds consumed
    stage_rows<D>(Ks, k, b, Lk, Hkv, hk, k0);
    stage_rows<D>(Vs, v, b, Lk, Hkv, hk, k0);
    if (Mask::kOn) {
      mask.stage(bs, mrow, k0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[4][4];
    dot_rows<D>(Qs, Ks, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = tx + 16 * c, j = k0 + jl;
        ok[c] = j < Lk && (!causal || j <= i) && mask.sees(bs, jl, i);
        s[r][c] = ok[c] ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        sum += p;
        Ps[(ty + 16 * r) * PP + tx + 16 * c] = p;
      }
      l[r] = alpha * l[r] + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();
    acc_pv<D>(Ps, Vs, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= Lq) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    store_row<D>(o, acc[r], 1.f / safe_l, b, i, Lq, H, h);
    if (tx == 0)
      lse[(size_t)bh * Lq + i] = l[r] == 0.f ? NEG_INF : m[r] + logf(safe_l);
  }
}

template <int D, class Mask>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Lq, int Lk, int H, int Hkv,
                       float scale, int causal, Mask mask,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(3, 1) +
      sizeof(int) * (mask.live_words() + Mask::kBoundInts);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + TILE - 1) / TILE, B * H);
  fwd_kernel<D, Mask><<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Lq,
      Lk, H, Hkv, scale, causal, mask);
  return cudaGetLastError();
}

// dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); D 64, 128
template <class Mask>
cudaError_t forward(int dtype, const void* q, const void* k, const void* v,
                    void* o, float* lse, int B, int Lq, int Lk, int H,
                    int Hkv, int D, float scale, int causal, Mask mask,
                    cudaStream_t st) {
  if (dtype == 0 && D == 64)
    return launch_fwd<64>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, scale, causal,
                          mask, st);
  if (dtype == 0 && D == 128)
    return launch_fwd<128>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, scale,
                           causal, mask, st);
  if (dtype == 1 && D == 64)
    return launch_fwd_tma<64>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, scale,
                              causal, mask, st);
  if (dtype == 1 && D == 128)
    return launch_fwd_tma<128>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, scale,
                               causal, mask, st);
  return cudaErrorInvalidValue;
}

}  // namespace fa
}  // namespace ptt
