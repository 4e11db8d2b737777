// The FA-2 backward of flash attention under a column mask policy
// (flash_attention.cuh): K1dq / K1dkv (NoMask, flash_attention_bwd.cu)
// and K6dq / K6dkv (ColumnMask, flashmask_bwd.cu). Two kernels that
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
// Design, dq: one block per (batch * head, 64-row q tile), gridded like
// the forward. Q, dO and the tile's lse and delta stay put while the
// block walks its live kv tiles (up to the diagonal when causal, and
// past the tiles a column mask hides from the whole q tile); it forms
// S, dP and dS = P * (dP - delta) * scale, rounds dS to K's dtype (the
// reference's ds.astype(k.dtype)) and accumulates dq += dS K in float32.
//
// Design, dk/dv: one block per (batch * kv head, 64-row kv tile). K and V
// stay put; the block walks every query head of its kv group and every
// q tile at or below the diagonal (the reference's flattened
// n_t = group * n_q axis), jumping each head's range of q tiles that a
// column mask hides from the whole kv tile; each head reads its own
// mask row. The group's sum is formed inside one block: deterministic,
// with no atomics. Per q tile it forms the transposed scores
// S^T = K Q^T and dP^T = V dO^T, P^T and dS^T (each rounded to the input
// dtype before its product, as the reference's p.astype and ds.astype),
// and accumulates dv += P^T dO and dk += dS^T Q in float32.
//
// A masked entry has P = 0 exactly (never exp(s - lse), which a row that
// sees nothing, lse = NEG_INF, would make 1), so such a row's dq is 0.
//
// bfloat16 runs on the tensor cores (mma.sync, 4 warps of 16 rows, the
// streaming operands double-buffered by cp.async, S / dP and P / dS kept
// in registers, rounded to bf16 as they become A operands); float32 on
// the CUDA cores (256 threads, float32 shared-memory tiles), since TF32
// would not hold float32 to the reference. Tail tiles mask columns past
// Lk and rows past Lq, so any L works. Neither uses wgmma or TMA yet.
#pragma once

#include "flash_attention.cuh"

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

// bfloat16 on the tensor cores. dq: 4 warps, 16 q rows each, Q and dO
// staged once, K/V tiles (and a column mask's bounds) double-buffered by
// cp.async; each 32-column half of a kv tile forms S and dP, then dS
// (rounded to bf16 as it becomes the A operand) into dq += dS K.
template <int D, class Mask>
__global__ void __launch_bounds__(MT)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int Lq, int Lk, int H, int Hkv, float scale, int causal,
                  Mask mask) {
  constexpr int LD = D + 8, NO = D / 8, NB = Mask::kBoundInts;
  const int q0 = blockIdx.x * TILE, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* dOs = Qs + TILE * LD;
  bf16* Ks = dOs + TILE * LD;           // [2][64][LD]
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
  async_rows<D>(dOs, dout, b, Lq, H, h, q0);
  if (t < n_kt) fetch(t, 0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  float lse_r[2], dl_r[2], acc[NO][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = row0 + 8 * hr;
    lse_r[hr] = i < Lq ? lse[(size_t)bh * Lq + i] : 0.f;
    dl_r[hr] = i < Lq ? delta[(size_t)bh * Lq + i] : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
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
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D; ks += 16) {
        uint32_t aq[4], ado[4];
        frag_a<LD>(aq, Qs, warp * 16, ks);
        frag_a<LD>(ado, dOs, warp * 16, ks);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          frag_bt<LD>(bb, kt, c0 + np * 16, ks);
          mma_pair(s[2 * np], s[2 * np + 1], aq, bb);
          frag_bt<LD>(bb, vt, c0 + np * 16, ks);
          mma_pair(dp[2 * np], dp[2 * np + 1], ado, bb);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e / 2, i = row0 + 8 * hr;
          const int jl = c0 + nt * 8 + 2 * tig + (e & 1), j = k0 + jl;
          const bool ok = i < Lq && j < Lk && (!causal || j <= i) &&
                          mask.sees(bs, jl, i);
          const float p = ok ? expf(s[nt][e] * scale - lse_r[hr]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - dl_r[hr]) * scale;   // dS
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bb[4];
          frag_b<LD>(bb, kt, c0 + kk * 16, np * 16);
          mma_pair(acc[2 * np], acc[2 * np + 1], a, bb);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
    t = tn;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = row0 + 8 * hr;
    if (i < Lq) store_acc_row<D>(dq, acc, hr, 1.f, b, i, Lq, H, h);
  }
}

// dk/dv: 4 warps, 16 kv rows each; K and V staged once; the (query head
// of the group, q tile) items stream through a double buffer of Q, dO,
// their lse / delta rows (and the head's mask bounds). Each 32-column
// half of a q tile forms S^T and dP^T, then P^T and dS^T (rounded to
// bf16 as A operands) into dv += P^T dO and dk += dS^T Q.
template <int D, class Mask>
__global__ void __launch_bounds__(MT)
    dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int Lq, int Lk, int H, int Hkv,
                   float scale, int causal, Mask mask) {
  constexpr int LD = D + 8, NO = D / 8, NB = Mask::kBoundInts;
  const int k0 = blockIdx.x * TILE, bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv, rep = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(fa_smem);
  bf16* Vs = Ks + TILE * LD;
  bf16* Qs = Vs + TILE * LD;            // [2][64][LD]
  bf16* dOs = Qs + 2 * TILE * LD;       // [2][64][LD]
  float* rows_s = reinterpret_cast<float*>(dOs + 2 * TILE * LD);
  // rows_s: [2 buffers][lse 64 | delta 64]
  int* dead = reinterpret_cast<int*>(rows_s + 4 * TILE);
  int* Bs = dead + mask.dead_ints(rep);   // [2][NB]

  const int qt0 = causal ? k0 / TILE : 0;
  const int n_qt = (Lq + TILE - 1) / TILE - qt0;   // q tiles per head
  const int n_items = rep * n_qt;
  auto fetch = [&](int u, int buf) {   // item u -> buffer buf
    const int h = hk * rep + u / n_qt, q0 = (qt0 + u % n_qt) * TILE;
    async_rows<D>(Qs + buf * TILE * LD, q, b, Lq, H, h, q0);
    async_rows<D>(dOs + buf * TILE * LD, dout, b, Lq, H, h, q0);
    mask.stage(Bs + buf * NB, mask.row(b, h, H), k0);
    const size_t base = ((size_t)b * H + h) * Lq;
    float* rs = rows_s + buf * 2 * TILE;
    for (int r = threadIdx.x; r < TILE; r += MT) {
      const bool ok = q0 + r < Lq;
      rs[r] = ok ? lse[base + q0 + r] : 0.f;
      rs[TILE + r] = ok ? delta[base + q0 + r] : 0.f;
    }
  };
  mask.init_dead(dead, b, hk, rep, H, blockIdx.x, Lq);
  if (Mask::kOn) __syncthreads();
  int u = mask.next_item(dead, 0, n_qt, qt0, n_items);
  async_rows<D>(Ks, k, b, Lk, Hkv, hk, k0);
  async_rows<D>(Vs, v, b, Lk, Hkv, hk, k0);
  if (u < n_items) fetch(u, 0);
  cp_async_commit();

  const int j_row = k0 + warp * 16 + g;   // this thread's kv rows: +0, +8
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  for (int it = 0; u < n_items; ++it) {
    const int un = mask.next_item(dead, u + 1, n_qt, qt0, n_items);
    if (un < n_items) fetch(un, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt0 + u % n_qt) * TILE;
    const bf16* qt = Qs + (it & 1) * TILE * LD;
    const bf16* dot = dOs + (it & 1) * TILE * LD;
    const float* rs = rows_s + (it & 1) * 2 * TILE;
    const int* bs = Bs + (it & 1) * NB;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D; ks += 16) {
        uint32_t ak[4], av[4];
        frag_a<LD>(ak, Ks, warp * 16, ks);
        frag_a<LD>(av, Vs, warp * 16, ks);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          frag_bt<LD>(bb, qt, c0 + np * 16, ks);
          mma_pair(st[2 * np], st[2 * np + 1], ak, bb);
          frag_bt<LD>(bb, dot, c0 + np * 16, ks);
          mma_pair(dpt[2 * np], dpt[2 * np + 1], av, bb);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j_row + 8 * (e / 2);
          const int ic = c0 + nt * 8 + 2 * tig + (e & 1), i = q0 + ic;
          const bool ok = i < Lq && j < Lk && (!causal || j <= i) &&
                          mask.sees(bs, j - k0, i);
          const float p = ok ? expf(st[nt][e] * scale - rs[ic]) : 0.f;
          st[nt][e] = p;                                        // P^T
          dpt[nt][e] = p * (dpt[nt][e] - rs[TILE + ic]) * scale;  // dS^T
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bb[4];
          frag_b<LD>(bb, dot, c0 + kk * 16, np * 16);
          mma_pair(dv_acc[2 * np], dv_acc[2 * np + 1], ap, bb);
          frag_b<LD>(bb, qt, c0 + kk * 16, np * 16);
          mma_pair(dk_acc[2 * np], dk_acc[2 * np + 1], ads, bb);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two items on
    u = un;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = j_row + 8 * hr;
    if (j >= Lk) continue;
    store_acc_row<D>(dk, dk_acc, hr, 1.f, b, j, Lk, Hkv, hk);
    store_acc_row<D>(dv, dv_acc, hr, 1.f, b, j, Lk, Hkv, hk);
  }
}

template <int D, class Mask>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int Lq,
                          int Lk, int H, int Hkv, float scale, int causal,
                          Mask mask, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>(
      6, mask.live_words() + 2 * Mask::kBoundInts);
  cudaError_t err = cudaFuncSetAttribute(
      dq_mma_kernel<D, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + TILE - 1) / TILE, B * H);
  dq_mma_kernel<D, Mask><<<grid, MT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dq, Lq, Lk, H, Hkv, scale, causal, mask);
  return cudaGetLastError();
}

template <int D, class Mask>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv, int B,
                           int Lq, int Lk, int H, int Hkv, float scale,
                           int causal, Mask mask, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>(
      6, 4 * TILE + mask.dead_ints(H / Hkv) + 2 * Mask::kBoundInts);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_mma_kernel<D, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lk + TILE - 1) / TILE, B * Hkv);
  dkv_mma_kernel<D, Mask><<<grid, MT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dk, (bf16*)dv, Lq, Lk, H, Hkv, scale, causal, mask);
  return cudaGetLastError();
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
// cores), 1 = bfloat16 (tensor cores); D 64, 128
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
    return launch_dq_mma<64>(q, k, v, dout, lse, delta, out0, B, Lq, Lk, H,
                             Hkv, scale, causal, mask, st);
  if (dtype == 1 && which == 0 && D == 128)
    return launch_dq_mma<128>(q, k, v, dout, lse, delta, out0, B, Lq, Lk, H,
                              Hkv, scale, causal, mask, st);
  if (dtype == 1 && which == 1 && D == 64)
    return launch_dkv_mma<64>(q, k, v, dout, lse, delta, out0, out1, B, Lq,
                              Lk, H, Hkv, scale, causal, mask, st);
  if (dtype == 1 && which == 1 && D == 128)
    return launch_dkv_mma<128>(q, k, v, dout, lse, delta, out0, out1, B, Lq,
                               Lk, H, Hkv, scale, causal, mask, st);
  return cudaErrorInvalidValue;
}

}  // namespace fa
}  // namespace ptt
