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
// Design: one block per (batch * head, 64-row q tile). The block walks
// the live kv tiles of its kv head (under causal, only up to the tile
// that holds the diagonal, as the TPU kernels' `live` predicate skips
// the tiles above it; under a column mask, also not the tiles that mask
// every row of the q tile), with an online softmax: the state (m, l) of
// each row and its output accumulator stay in float32 registers, and
// the block ends with acc / l and lse = m + log l (NEG_INF for a row
// that saw no column), as the TPU kernels' _finish does. l sums the
// unrounded P. Columns past Lk and rows past Lq are masked, so any L
// works; causal is top-left (column j visible to row i iff j <= i).
// A masked entry is set to exactly NEG_INF and its P to exactly 0 (the
// guard the TPU kernel writes as s <= NEG_INF / 2), so a row that sees
// nothing ends with o = 0 and lse = NEG_INF.
//
// bfloat16 runs on the tensor cores: 4 warps of 16 q rows each, Q staged
// once and K/V tiles (and a column mask's bounds) double-buffered by
// cp.async; S = Q K^T comes out of mma.sync in float32 registers, P is
// rounded to bf16 as it becomes the A operand of P V (FA-2's recipe and
// the reference's p.astype(v.dtype)). float32 runs on the CUDA cores
// (256 threads, each scoring a 4 x 4 part of the 64 x 64 tile from
// float32 shared-memory tiles), since the tensor cores' TF32 would not
// hold float32 to the reference. Neither uses wgmma or TMA yet, so both
// run well above their bound.
#pragma once

#include "flash_attention.cuh"

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

// bfloat16 on the tensor cores: 4 warps, 16 q rows each; K/V tiles
// double-buffered by cp.async; S and P stay in registers
template <int D, class Mask>
__global__ void __launch_bounds__(MT)
    fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, int Lq, int Lk, int H, int Hkv,
                   float scale, int causal, Mask mask) {
  constexpr int LD = D + 8, NS = TILE / 8, NO = D / 8;
  constexpr int NB = Mask::kBoundInts;
  const int q0 = blockIdx.x * TILE, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* Ks = Qs + TILE * LD;            // [2][64][LD]
  bf16* Vs = Ks + 2 * TILE * LD;        // [2][64][LD]
  unsigned* live = reinterpret_cast<unsigned*>(Vs + 2 * TILE * LD);
  int* Bs = reinterpret_cast<int*>(live + mask.live_words());   // [2][NB]

  const int q_last = min(q0 + TILE, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  const int n_kt = (k_end + TILE - 1) / TILE;
  const int mrow = mask.row(b, h, H);
  auto fetch = [&](int t, int buf) {
    async_rows<D>(Ks + buf * TILE * LD, k, b, Lk, Hkv, hk, t * TILE);
    async_rows<D>(Vs + buf * TILE * LD, v, b, Lk, Hkv, hk, t * TILE);
    mask.stage(Bs + buf * NB, mrow, t * TILE);
  };
  mask.init_live(live, mrow, n_kt, q0, q_last);
  if (Mask::kOn) __syncthreads();
  int t = mask.next_live(live, 0, n_kt);
  async_rows<D>(Qs, q, b, Lq, H, h, q0);
  if (t < n_kt) fetch(t, 0);
  cp_async_commit();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: +0, +8
  for (int it = 0; t < n_kt; ++it) {
    const int k0 = t * TILE;
    const int tn = mask.next_live(live, t + 1, n_kt);
    if (tn < n_kt) fetch(tn, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = Ks + (it & 1) * TILE * LD;
    const bf16* vt = Vs + (it & 1) * TILE * LD;
    const int* bs = Bs + (it & 1) * NB;
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D; ks += 16) {
      uint32_t a[4];
      frag_a<LD>(a, Qs, warp * 16, ks);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bb[4];
        frag_bt<LD>(bb, kt, np * 16, ks);
        mma_pair(s[2 * np], s[2 * np + 1], a, bb);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = row0 + 8 * hr;
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = nt * 8 + 2 * tig + e, j = k0 + jl;
          float& x = s[nt][2 * hr + e];
          x = (j < Lk && (!causal || j <= i) && mask.sees(bs, jl, i))
                  ? x * scale
                  : NEG_INF;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[hr], quad_max(mx));
      const float alpha = expf(m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * hr + e];
          x = x == NEG_INF ? 0.f : expf(x - m_new);
          sum += x;
        }
      l[hr] = alpha * l[hr] + quad_sum(sum);
      m[hr] = m_new;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        acc[nt][2 * hr] *= alpha;
        acc[nt][2 * hr + 1] *= alpha;
      }
    }
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);   // P rounded to bf16
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bb[4];
        frag_b<LD>(bb, vt, kk * 16, np * 16);
        mma_pair(acc[2 * np], acc[2 * np + 1], a, bb);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
    t = tn;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = row0 + 8 * hr;
    if (i >= Lq) continue;
    const float safe_l = l[hr] == 0.f ? 1.f : l[hr];
    store_acc_row<D>(o, acc, hr, 1.f / safe_l, b, i, Lq, H, h);
    if (tig == 0)
      lse[(size_t)bh * Lq + i] = l[hr] == 0.f ? NEG_INF : m[hr] + logf(safe_l);
  }
}

template <int D, class Mask>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int Lq, int Lk, int H,
                           int Hkv, float scale, int causal, Mask mask,
                           cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>(
      5, mask.live_words() + 2 * Mask::kBoundInts);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_mma_kernel<D, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + TILE - 1) / TILE, B * H);
  fwd_mma_kernel<D, Mask><<<grid, MT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, Lq, Lk,
      H, Hkv, scale, causal, mask);
  return cudaGetLastError();
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
    return launch_fwd_mma<64>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, scale,
                              causal, mask, st);
  if (dtype == 1 && D == 128)
    return launch_fwd_mma<128>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, scale,
                               causal, mask, st);
  return cudaErrorInvalidValue;
}

}  // namespace fa
}  // namespace ptt
