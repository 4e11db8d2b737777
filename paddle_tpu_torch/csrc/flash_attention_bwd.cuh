// The FA-2 backward of flash attention under a column mask policy
// (flash_attention.cuh): K1dq / K1dkv (NoMask, flash_attention_bwd.cu)
// and K6dq / K6dkv (ColumnMask, flashmask_bwd.cu). Two passes that
// recompute P = exp(scale * Q K^T - lse) from the forward's saved row
// log-sum-exp instead of storing an L x L matrix; delta = rowsum(dO * O)
// comes from the caller, as the reference computes it in XLA.
//
// What bounds them on the H100: operations. dq recomputes S and dP and
// forms dS K (three products over the visible pairs: the causal half of
// the square, or what a column mask leaves); dk/dv recomputes S and dP
// and forms P^T dO and dS^T Q (four). At L = 4096 that is thousands of
// flops per byte moved, so the least time is the flops at the dense
// bf16 tensor-core rate.
//
// bfloat16 runs the Hopper kernels of flash_attention_bwd_sm90.cuh
// (wgmma, TMA, a producer warpgroup and two consumer warpgroups; the
// design is there). float32 runs the two kernels below on the CUDA
// cores (256 threads, float32 shared-memory tiles), since TF32 would not
// hold float32 to the reference:
//
// dq: one block per (batch * head, 64-row q tile). Q, dO and the tile's
// lse and delta stay put while the block walks its live kv tiles (up to
// the diagonal when causal, and past the tiles a column mask hides from
// the whole q tile); it forms S, dP and dS = P * (dP - delta) * scale
// and accumulates dq += dS K.
//
// dk/dv: one block per (batch * kv head, 64-row kv tile). K and V stay
// put; the block walks every query head of its kv group and every q
// tile at or below the diagonal (the reference's flattened n_t = group
// * n_q axis), jumping each head's range of q tiles that a column mask
// hides from the whole kv tile; each head reads its own mask row. The
// group's sum is formed inside one block: deterministic, with no
// atomics. Per q tile it forms S^T = K Q^T and dP^T = V dO^T, P^T and
// dS^T, and accumulates dv += P^T dO and dk += dS^T Q.
//
// A masked entry has P = 0 exactly (never exp(s - lse), which a row that
// sees nothing, lse = NEG_INF, would make 1), so such a row's dq is 0.
// Tail tiles mask columns past Lk and rows past Lq, so any L works.
#pragma once

#include "flash_attention.cuh"
#include "flash_attention_bwd_sm90.cuh"

namespace ptt {
namespace fa {

// float32 on the CUDA cores
template <int D, class Mask>
__global__ void __launch_bounds__(NT)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Lq, int Lk, int H, int Hkv,
              float scale, int causal, Mask mask) {
  constexpr int DP = D + 1, DC = D / 16;
  const int q0 = blockIdx.x * TILE, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TILE * DP;
  float* Ks = dOs + TILE * DP;
  float* Vs = Ks + TILE * DP;
  float* dSs = Vs + TILE * DP;
  unsigned* live = reinterpret_cast<unsigned*>(dSs + TILE * PP);
  int* bs = reinterpret_cast<int*>(live + mask.live_words());

  const int q_last = min(q0 + TILE, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  const int n_kt = (k_end + TILE - 1) / TILE;
  const int mrow = mask.row(b, h, H);
  stage_rows<D>(Qs, q, b, Lq, H, h, q0);
  stage_rows<D>(dOs, dout, b, Lq, H, h, q0);
  mask.init_live(live, mrow, n_kt, q0, q_last);
  if (Mask::kOn) __syncthreads();
  float lse_r[4], dl_r[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    lse_r[r] = i < Lq ? lse[(size_t)bh * Lq + i] : 0.f;
    dl_r[r] = i < Lq ? delta[(size_t)bh * Lq + i] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  for (int t = mask.next_live(live, 0, n_kt); t < n_kt;
       t = mask.next_live(live, t + 1, n_kt)) {
    const int k0 = t * TILE;
    __syncthreads();  // Q, dO staged; the previous K, dS, bounds consumed
    stage_rows<D>(Ks, k, b, Lk, Hkv, hk, k0);
    stage_rows<D>(Vs, v, b, Lk, Hkv, hk, k0);
    if (Mask::kOn) {
      mask.stage(bs, mrow, k0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_rows<D>(Qs, Ks, s);
    dot_rows<D>(dOs, Vs, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = tx + 16 * c, j = k0 + jl;
        const bool ok = i < Lq && j < Lk && (!causal || j <= i) &&
                        mask.sees(bs, jl, i);
        const float p = ok ? expf(s[r][c] * scale - lse_r[r]) : 0.f;
        dSs[(ty + 16 * r) * PP + jl] = p * (dp[r][c] - dl_r[r]) * scale;
      }
    }
    __syncthreads();
    acc_pv<D>(dSs, Ks, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i < Lq) store_row<D>(dq, acc[r], 1.f, b, i, Lq, H, h);
  }
}

template <int D, class Mask>
__global__ void __launch_bounds__(NT)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int Lq, int Lk, int H, int Hkv,
               float scale, int causal, Mask mask) {
  constexpr int DP = D + 1, DC = D / 16;
  const int k0 = blockIdx.x * TILE, bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv, rep = H / Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * DP;
  float* Qs = Vs + TILE * DP;
  float* dOs = Qs + TILE * DP;
  float* Pt = dOs + TILE * DP;
  float* dSt = Pt + TILE * PP;
  int* dead = reinterpret_cast<int*>(dSt + TILE * PP);
  int* bs = dead + mask.dead_ints(rep);

  stage_rows<D>(Ks, k, b, Lk, Hkv, hk, k0);
  stage_rows<D>(Vs, v, b, Lk, Hkv, hk, k0);
  mask.init_dead(dead, b, hk, rep, H, blockIdx.x, Lq);
  if (Mask::kOn) __syncthreads();
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  // causal: row i sees column j iff j <= i, so q tiles before the one
  // holding row k0 see nothing of this kv tile
  const int qt0 = causal ? k0 / TILE : 0;
  const int n_qt = (Lq + TILE - 1) / TILE - qt0;   // q tiles per head
  const int n_items = rep * n_qt;
  for (int u = mask.next_item(dead, 0, n_qt, qt0, n_items); u < n_items;
       u = mask.next_item(dead, u + 1, n_qt, qt0, n_items)) {
    const int h = hk * rep + u / n_qt, q0 = (qt0 + u % n_qt) * TILE;
    const size_t bh = (size_t)b * H + h;
    __syncthreads();  // K, V staged; the previous Q, dO, P, dS consumed
    stage_rows<D>(Qs, q, b, Lq, H, h, q0);
    stage_rows<D>(dOs, dout, b, Lq, H, h, q0);
    if (Mask::kOn) {
      mask.stage(bs, mask.row(b, h, H), k0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    float lse_c[4], dl_c[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = q0 + tx + 16 * c;
      lse_c[c] = i < Lq ? lse[bh * Lq + i] : 0.f;
      dl_c[c] = i < Lq ? delta[bh * Lq + i] : 0.f;
    }
    float st[4][4], dpt[4][4];
    dot_rows<D>(Ks, Qs, st);
    dot_rows<D>(Vs, dOs, dpt);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jl = ty + 16 * r, j = k0 + jl;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = q0 + tx + 16 * c;
        const bool ok = i < Lq && j < Lk && (!causal || j <= i) &&
                        mask.sees(bs, jl, i);
        const float p = ok ? expf(st[r][c] * scale - lse_c[c]) : 0.f;
        Pt[jl * PP + tx + 16 * c] = p;
        dSt[jl * PP + tx + 16 * c] = p * (dpt[r][c] - dl_c[c]) * scale;
      }
    }
    __syncthreads();
    acc_pv<D>(Pt, dOs, dv_acc);
    acc_pv<D>(dSt, Qs, dk_acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= Lk) continue;
    store_row<D>(dk, dk_acc[r], 1.f, b, j, Lk, Hkv, hk);
    store_row<D>(dv, dv_acc[r], 1.f, b, j, Lk, Hkv, hk);
  }
}

template <int D, class Mask>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int Lq, int Lk, int H, int Hkv,
                      float scale, int causal, Mask mask,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(4, 1) +
      sizeof(int) * (mask.live_words() + Mask::kBoundInts);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<D, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + TILE - 1) / TILE, B * H);
  dq_kernel<D, Mask><<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dq, Lq, Lk, H, Hkv, scale, causal, mask);
  return cudaGetLastError();
}

template <int D, class Mask>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int Lq,
                       int Lk, int H, int Hkv, float scale, int causal,
                       Mask mask, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(4, 2) +
      sizeof(int) * (mask.dead_ints(H / Hkv) + Mask::kBoundInts);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<D, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lk + TILE - 1) / TILE, B * Hkv);
  dkv_kernel<D, Mask><<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, Lq, Lk, H, Hkv, scale, causal,
      mask);
  return cudaGetLastError();
}

// which 0 = dq (out0), 1 = dk / dv (out0, out1); dtype 0 = float32 (CUDA
// cores), 1 = bfloat16 (the Hopper kernels of flash_attention_bwd_sm90.cuh);
// D 64, 128
template <class Mask>
cudaError_t backward(int which, int dtype, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* delta, void* out0, void* out1, int B,
                     int Lq, int Lk, int H, int Hkv, int D, float scale,
                     int causal, Mask mask, cudaStream_t st) {
  if (dtype == 0 && which == 0 && D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, out0, B, Lq, Lk, H, Hkv,
                         scale, causal, mask, st);
  if (dtype == 0 && which == 0 && D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, out0, B, Lq, Lk, H, Hkv,
                          scale, causal, mask, st);
  if (dtype == 0 && which == 1 && D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, out0, out1, B, Lq, Lk,
                          H, Hkv, scale, causal, mask, st);
  if (dtype == 0 && which == 1 && D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, out0, out1, B, Lq, Lk,
                           H, Hkv, scale, causal, mask, st);
  if (dtype == 1 && which == 0 && D == 64)
    return launch_dq_tma<64>(q, k, v, dout, lse, delta, out0, B, Lq, Lk, H,
                             Hkv, scale, causal, mask, st);
  if (dtype == 1 && which == 0 && D == 128)
    return launch_dq_tma<128>(q, k, v, dout, lse, delta, out0, B, Lq, Lk, H,
                              Hkv, scale, causal, mask, st);
  if (dtype == 1 && which == 1 && D == 64)
    return launch_dkv_tma<64>(q, k, v, dout, lse, delta, out0, out1, B, Lq,
                              Lk, H, Hkv, scale, causal, mask, st);
  if (dtype == 1 && which == 1 && D == 128)
    return launch_dkv_tma<128>(q, k, v, dout, lse, delta, out0, out1, B, Lq,
                               Lk, H, Hkv, scale, causal, mask, st);
  return cudaErrorInvalidValue;
}

}  // namespace fa
}  // namespace ptt
