// K1f: flash attention forward with the row log-sum-exp,
// o = softmax(scale * Q K^T + causal) V over [B, L, H, D] (GQA: kv head
// h / (H / Hkv)).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention_kernel.py, _fwd_kernel
// (via _fwd / pallas_flash_attention).
//
// What bounds it on the H100: operations. A causal pass does
// 2 * B * H * L^2 * D multiply-adds (two products over half the square),
// which at L = 4096 is ~2000 flops per byte of Q, K, V and O, far above
// the card's ~295 flops per byte; the least time is those flops at the
// dense bf16 tensor-core rate.
//
// Design: one block per (batch * head, 64-row q tile). The block walks
// the kv tiles of its kv head, stopping after the tile that holds the
// diagonal when causal (as the TPU kernel's `live` predicate skips the
// tiles above it), with an online softmax: the state (m, l) of each row
// and its output accumulator stay in float32 registers, and the block
// ends with acc / l and lse = m + log l (NEG_INF for a row that saw no
// column), as the TPU kernel's _finish does. l sums the unrounded P.
// Columns past Lk and rows past Lq are masked, so any L works; causal is
// top-left (column j visible to row i iff j <= i).
//
// bfloat16 runs on the tensor cores: 4 warps of 16 q rows each, Q staged
// once and K/V tiles double-buffered by cp.async; S = Q K^T comes out of
// mma.sync in float32 registers, P is rounded to bf16 as it becomes the
// A operand of P V (FA-2's recipe and the reference's p.astype(v.dtype)).
// float32 runs on the CUDA cores (256 threads, each scoring a 4 x 4 part
// of the 64 x 64 tile from float32 shared-memory tiles), since the
// tensor cores' TF32 would not hold float32 to the reference. Neither
// uses wgmma or TMA yet, so both run well above their bound.
#include "flash_attention.cuh"

namespace {

using namespace ptt;
using namespace ptt::fa;

// float32 on the CUDA cores
template <int D>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int Lq, int Lk, int H, int Hkv,
               float scale, int causal) {
  constexpr int DP = D + 1, DC = D / 16;
  const int q0 = blockIdx.x * TILE, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * DP;
  float* Vs = Ks + TILE * DP;
  float* Ps = Vs + TILE * DP;

  stage_rows<D>(Qs, q, b, Lq, H, h, q0);
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  const int q_last = min(q0 + TILE, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // Q staged; the previous K, V and P consumed
    stage_rows<D>(Ks, k, b, Lk, Hkv, hk, k0);
    stage_rows<D>(Vs, v, b, Lk, Hkv, hk, k0);
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
        const int j = k0 + tx + 16 * c;
        ok[c] = j < Lk && (!causal || j <= i);
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
template <int D>
__global__ void __launch_bounds__(MT)
    fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, int Lq, int Lk, int H, int Hkv,
                   float scale, int causal) {
  constexpr int LD = D + 8, NS = TILE / 8, NO = D / 8;
  const int q0 = blockIdx.x * TILE, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* Ks = Qs + TILE * LD;            // [2][64][LD]
  bf16* Vs = Ks + 2 * TILE * LD;        // [2][64][LD]

  const int q_last = min(q0 + TILE, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  const int n_kt = (k_end + TILE - 1) / TILE;
  async_rows<D>(Qs, q, b, Lq, H, h, q0);
  async_rows<D>(Ks, k, b, Lk, Hkv, hk, 0);
  async_rows<D>(Vs, v, b, Lk, Hkv, hk, 0);
  cp_async_commit();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: +0, +8
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * TILE;
    if (t + 1 < n_kt) {
      const int nb = ((t + 1) & 1) * TILE * LD;
      async_rows<D>(Ks + nb, k, b, Lk, Hkv, hk, k0 + TILE);
      async_rows<D>(Vs + nb, v, b, Lk, Hkv, hk, k0 + TILE);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = Ks + (t & 1) * TILE * LD;
    const bf16* vt = Vs + (t & 1) * TILE * LD;
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
          const int j = k0 + nt * 8 + 2 * tig + e;
          float& x = s[nt][2 * hr + e];
          x = (j < Lk && (!causal || j <= i)) ? x * scale : NEG_INF;
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

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Lq, int Lk, int H, int Hkv,
                       float scale, int causal, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>(5, 0);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + TILE - 1) / TILE, B * H);
  fwd_mma_kernel<D><<<grid, MT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, Lq, Lk,
      H, Hkv, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Lq, int Lk, int H, int Hkv,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(3, 1);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + TILE - 1) / TILE, B * H);
  fwd_kernel<D><<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Lq,
      Lk, H, Hkv, scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_d(int dtype, const void* q, const void* k,
                       const void* v, void* o, float* lse, int B, int Lq,
                       int Lk, int H, int Hkv, int D, float scale,
                       int causal, cudaStream_t st) {
  if (dtype == 0 && D == 64)
    return launch<64>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, scale, causal,
                      st);
  if (dtype == 0 && D == 128)
    return launch<128>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, scale, causal,
                       st);
  if (dtype == 1 && D == 64)
    return launch_mma<64>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, scale, causal,
                          st);
  if (dtype == 1 && D == 128)
    return launch_mma<128>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, scale,
                           causal, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o [B, Lq, H, D]; k, v [B, Lk, Hkv, D]; lse [B, H, Lq] float32.
// D in {64, 128}; H % Hkv == 0; dtype 0 = float32, 1 = bfloat16.
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Lq, int Lk, int H, int Hkv,
                                       int D, float scale, int causal,
                                       int dtype, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || H % Hkv != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_d(dtype, q, k, v, o, (float*)lse, B, Lq, Lk, H, Hkv,
                         D, scale, causal, (cudaStream_t)stream);
}
