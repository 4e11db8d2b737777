// The bf16 flash attention forward for Hopper (sm_90a), under a column
// mask policy: K1f (NoMask) and K6f (ColumnMask) run this one template.
//
// o = softmax(scale * Q K^T + mask) V and lse over [B, L, H, D] (GQA: kv
// head h / (H / Hkv)), D 64 or 128, any Lq, Lk >= 1, causal top-left.
//
// What bounds it on the H100: operations, 4 D flops a visible pair at
// the dense bf16 tensor-core rate (989 TFLOP/s). Only wgmma reaches that
// rate; the softmax's exponentials (one MUFU op an entry, 16 a clock an
// SM against wgmma's ~4096 flops) are the next limit, then the copies.
//
// Design (after FlashAttention-3):
// - Block: one (batch * head, 128-row q tile), 384 threads in three
//   warpgroups, one block an SM. Warpgroup 0 produces: it gives its
//   registers back (setmaxnreg 24) and one thread issues TMA loads, Q
//   once and then the K and V tiles of 128 rows into two 2-slot rings,
//   K's and V's, each slot with a "full" mbarrier (TMA completes its
//   bytes) and an "empty" one (the 8 consumer warps release it). Under
//   a column mask the same warp also stages the K slot's 2 x 128 column
//   bounds and a flag: does some column of the tile hide a row of the q
//   tile.
// - Warpgroups 1 and 2 consume (setmaxnreg 240), 64 q rows each:
//   S = Q K^T by wgmma m64n128k16 with both operands read from swizzled
//   shared memory, S in float32 registers; the online softmax in
//   registers in the log2 domain (scale * log2 e folded into one
//   multiply, ex2.approx); P rounded to bf16 in registers (the
//   reference's p.astype(v.dtype)) is the A operand of O += P V, wgmma
//   m64n{D}k16 with V read through the descriptor's transpose bit, so V
//   is never copied transposed. Tile t's S is issued with tile t - 1's
//   P V, so each warpgroup's softmax overlaps its own P V, and the two
//   warpgroups take turns to issue (ping-pong on named barriers), so
//   one's exponentials overlap the other's products. A K slot is
//   released once the softmax has read its scores and bounds, a V slot
//   only after the wgmma that read it has been waited for.
// - Masking only where needed: a tile takes the per-entry predicate
//   (column < Lk, causal j <= i, the column mask's sees()) only if it
//   holds the causal diagonal of the warpgroup's rows, column Lk - 1, or
//   (column mask) a column that hides a row of the q tile. Interior
//   tiles take none. A masked entry is exactly NEG_INF and its P exactly
//   0, guarded explicitly (not by exp2 of a large negative), so a row
//   that sees nothing ends with o = 0 and lse = NEG_INF.
// - Heaviest tiles first: under causal the grid's slow axis walks the
//   q tiles from the last (the longest walk) down, across all heads, so
//   the short tiles fill the tail.
// - The walk: the kv tiles up to the causal diagonal, and under a column
//   mask only the live ones (a 128-column tile is live iff either of its
//   64-column halves of the mask's tile summary is), the same tiles in
//   the same order for K1 and K6, so a mask that hides nothing gives
//   K1's bits.
// - Epilogue: o = acc / l rounded to bf16, stored from registers; lse =
//   (m + log2 l) ln 2, natural log as the reference.
#pragma once

#include "flash_attention.cuh"
#include "hopper.cuh"

namespace ptt {
namespace fa {

constexpr int TMA_BM = 128;          // q rows of a block
constexpr int TMA_BN = 128;          // kv rows of a ring slot
constexpr int TMA_THREADS = 384;     // producer + two consumer warpgroups
constexpr int TMA_ATOM = 64;         // bf16 columns of a swizzle atom
constexpr float LOG2E = 1.4426950408889634f;

// a consumer's 64 x (16 K) accumulator (wgmma layout) -> the bf16 A
// fragments of its K k16 steps, rounded to nearest even (P for O += P
// V; P^T, dS^T and dS in the backward)
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K][4],
                                       const float (&x)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// shared memory of a block: Q, the K and V rings, 9 mbarriers, the
// bounds ring, the live bits, and slack to align the tiles to 1024 bytes
template <int D, class Mask>
size_t tma_smem_bytes(const Mask& mask) {
  constexpr size_t atom = (size_t)TMA_BN * TMA_ATOM * sizeof(bf16);
  return 1024 + atom * (D / TMA_ATOM) * 5 + 9 * sizeof(uint64_t) +
         sizeof(int) * (Mask::kOn ? 2 * (2 * TMA_BN + 1) : 0) +
         sizeof(unsigned) * mask.live_words();
}

// S of one kv tile (a consumer warpgroup's 64 x 128 scores, wgmma
// layout) -> P in place, in the log2 domain: masked where `edge` says
// the tile needs it, the rows' running max m and this thread's part of
// the running sum l updated; alpha[hr] is the factor that rescales the
// accumulator rows (the caller applies it once the wgmma reading the
// accumulator has been waited for)
template <int BN, class Mask>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BN / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool edge, int k0, int row0, int Lk, int causal, float scale_log2,
    const Mask& mask, const int* bs) {
  const int tig = threadIdx.x % 4;
  if (edge) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = 8 * j + 2 * tig + e, col = k0 + jl;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = row0 + 8 * hr;
          float& x = sc[4 * j + 2 * hr + e];
          x = (col < Lk && (!causal || col <= i) &&
               mask.template sees<BN>(bs, jl, i))
                  ? x * scale_log2
                  : NEG_INF;
        }
      }
  } else {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sc[e] *= scale_log2;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
    const float m_new = fmaxf(m[hr], quad_max(mx));
    alpha[hr] = ex2(m[hr] - m_new);
    float sum = 0.f;
    if (edge) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * hr + e];
          x = x == NEG_INF ? 0.f : ex2(x - m_new);
          sum += x;
        }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * hr + e];
          x = ex2(x - m_new);
          sum += x;
        }
    }
    l[hr] = alpha[hr] * l[hr] + sum;
    m[hr] = m_new;
  }
}

// The producer of a block that streams K and V tiles of BN rows through
// two S-slot rings (K's and V's, each slot with a "full" mbarrier that
// TMA completes and an "empty" one that the 8 consumer warps arrive on):
// warp 0 of warpgroup 0, all 32 lanes, walks the live kv tiles; for
// each it waits for the K slot, stages the tile's column bounds and a
// flag (column mask: does some column hide a row of [q_first, q_last]),
// loads K, then waits for the V slot and loads V. Item it takes slot
// it % S in phase it / S. K1f / K6f (BN 128, S 2) and K1dq / K6dq (BN
// 64) run it; their consumers decide when each slot is released.
template <int D, int BN, int S, class Mask>
__device__ __forceinline__ void produce_kv(
    const CUtensorMap* tk, const CUtensorMap* tv, bf16* Ks, bf16* Vs,
    uint64_t* k_full, uint64_t* v_full, uint64_t* k_empty,
    uint64_t* v_empty, int* Bs, const unsigned* live, int n_kt, int hk,
    int b, int mrow, int q_first, int q_last, const Mask& mask) {
  using namespace sm90;
  constexpr int NA = D / TMA_ATOM, ATOM = BN * TMA_ATOM, NBS = 2 * BN + 1;
  constexpr uint32_t TILE_BYTES = NA * ATOM * sizeof(bf16);
  const int lane = threadIdx.x % 32;
  int it = 0;
  for (int t = mask.next_live(live, 0, n_kt); t < n_kt;
       t = mask.next_live(live, t + 1, n_kt), ++it) {
    const int s = it % S, k0 = t * BN;
    const uint32_t free = ((it / S) & 1) ^ 1;
    mbar_wait(k_empty + s, free);
    if (Mask::kOn) {
      int* bs = Bs + s * NBS;
      const bool hides =
          mask.template load_bounds<BN>(bs, mrow, k0, q_first, q_last);
      if (lane == 0) bs[2 * BN] = hides;
      __threadfence_block();
      __syncwarp();
    }
    if (lane == 0) {
      mbar_expect_tx(k_full + s, TILE_BYTES);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_load_4d(Ks + (s * NA + a) * ATOM, tk, k_full + s, a * TMA_ATOM,
                    hk, k0, b);
    }
    mbar_wait(v_empty + s, free);
    if (lane == 0) {
      mbar_expect_tx(v_full + s, TILE_BYTES);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_load_4d(Vs + (s * NA + a) * ATOM, tv, v_full + s, a * TMA_ATOM,
                    hk, k0, b);
    }
  }
}

template <int D, class Mask>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    fwd_tma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ o, float* __restrict__ lse, int Lq,
                   int Lk, int H, int Hkv, float scale_log2, int causal,
                   Mask mask) {
  using namespace sm90;
  constexpr int BM = TMA_BM, BN = TMA_BN, NA = D / TMA_ATOM;
  constexpr int ATOM = BN * TMA_ATOM;          // elements of one atom
  constexpr int NBS = 2 * BN + 1;              // bounds + flag of a slot
  constexpr uint32_t TILE_BYTES = NA * ATOM * sizeof(bf16);
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  extern __shared__ unsigned char fa_raw[];
  unsigned char* base = fa_raw + ((1024 - (smem_u32(fa_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);    // [NA][128][64] swizzled
  bf16* Ks = Qs + NA * ATOM;                   // [2][NA][128][64]
  bf16* Vs = Ks + 2 * NA * ATOM;               // [2][NA][128][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + 2 * NA * ATOM);
  uint64_t* k_full = q_full + 1;               // [2] each
  uint64_t* v_full = q_full + 3;
  uint64_t* k_empty = q_full + 5;
  uint64_t* v_empty = q_full + 7;
  int* Bs = reinterpret_cast<int*>(q_full + 9);   // [2][NBS] (column mask)
  unsigned* live =
      reinterpret_cast<unsigned*>(Bs + (Mask::kOn ? 2 * NBS : 0));

  const int q_last = min(q0 + BM, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  const int n_kt = (k_end + BN - 1) / BN;
  const int mrow = mask.row(b, h, H);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 8);   // lane 0 of each consumer warp
      mbar_init(v_empty + s, 8);
    }
    fence_barrier_init();
  }
  mask.template init_live<BN / TILE>(live, mrow, n_kt, q0, q_last);
  __syncthreads();

  // warp-uniform roles (shuffled from lane 0), one branch each to the
  // kernel's end, so each role is compiled to its setmaxnreg budget
  const int wg = __shfl_sync(FULL_MASK, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------ producer
    regs_dealloc<24>();
    if (__shfl_sync(FULL_MASK, threadIdx.x / 32, 0) == 0) {
      if (threadIdx.x == 0) {
        prefetch_tmap(&tq);
        prefetch_tmap(&tk);
        prefetch_tmap(&tv);
        mbar_expect_tx(q_full, TILE_BYTES);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_4d(Qs + a * ATOM, &tq, q_full, a * TMA_ATOM, h, q0, b);
      }
      produce_kv<D, BN, 2>(&tk, &tv, Ks, Vs, k_full, v_full, k_empty,
                           v_empty, Bs, live, n_kt, hk, b, mrow, q0, q_last,
                           mask);
    }
  } else {
    // -------------------------------------------------------- consumers
    regs_alloc<240>();
    const int c = wg - 1;                        // 64-row half of the tile
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int tig = lane % 4;
    const int wg_first = q0 + 64 * c;
    const int row0 = wg_first + 16 * warp + lane / 4;   // rows +0, +8
    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this thread's
    float sc[BN / 2], alpha[2];
    uint32_t pa[BN / 16][4];                     // P as bf16 A fragments
    const uint64_t dq = desc_sw128(Qs + c * 64 * TMA_ATOM, 0, 1024);
    auto issue_s = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * ATOM + (kk % 4) * 16;   // elements
        wgmma_ss(sc, dq + off * sizeof(bf16) / 16,
                 desc_sw128(Ks + s * NA * ATOM + off, 0, 1024), kk > 0);
      }
    };
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_tb(acc, pa[kk],
                    desc_sw128(Vs + s * NA * ATOM + kk * 16 * TMA_ATOM,
                               ATOM * sizeof(bf16), 1024));
    };
    auto softmax = [&](int t, int s) {
      const int k0 = t * BN;
      const int* bs = Bs + s * NBS;
      const bool edge = (causal && k0 + BN - 1 > wg_first) || k0 + BN > Lk ||
                        (Mask::kOn && bs[2 * BN]);
      softmax_tile<BN>(sc, m, l, alpha, edge, k0, row0, Lk, causal,
                       scale_log2, mask, bs);
    };
    const int turn = 1 + c, other = 2 - c;       // named barriers
    mbar_wait(q_full, 0);   // also when no tile is live: Q's copy ends first
    int t = mask.next_live(live, 0, n_kt);
    if (t < n_kt) {
      if (c == 1) bar_arrive(other, 256);   // warpgroup 0 issues first
      mbar_wait(k_full, 0);
      bar_sync(turn, 256);
      wgmma_fence();
      issue_s(0);
      wgmma_commit();
      bar_arrive(other, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(t, 0);
      warp_arrive(k_empty);
      pack_a(pa, sc);
      int it = 1;
      for (t = mask.next_live(live, t + 1, n_kt); t < n_kt;
           t = mask.next_live(live, t + 1, n_kt), ++it) {
        const int s = it & 1, sp = s ^ 1;
        mbar_wait(k_full + s, (it >> 1) & 1);
        mbar_wait(v_full + sp, ((it - 1) >> 1) & 1);
        bar_sync(turn, 256);
        wgmma_fence();
        issue_s(s);
        wgmma_commit();
        issue_pv(sp);
        wgmma_commit();
        bar_arrive(other, 256);
        wgmma_wait<1>();
        fence_regs(sc);
        softmax(t, s);
        warp_arrive(k_empty + s);
        wgmma_wait<0>();
        fence_regs(acc);
        warp_arrive(v_empty + sp);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];
        pack_a(pa, sc);
      }
      const int sp = (it - 1) & 1;
      mbar_wait(v_full + sp, ((it - 1) >> 1) & 1);
      bar_sync(turn, 256);
      wgmma_fence();
      issue_pv(sp);
      wgmma_commit();
      if (c == 0) bar_arrive(other, 256);   // warpgroup 1 ends the turns
      wgmma_wait<0>();
      fence_regs(acc);
      warp_arrive(v_empty + sp);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = row0 + 8 * hr;
      const float sum = quad_sum(l[hr]);
      if (i >= Lq) continue;
      const float mul = sum == 0.f ? 1.f : 1.f / sum;
      bf16* dst = o + row_off<D>(b, i, Lq, H, h) + 2 * tig;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * hr] * mul, acc[4 * j + 2 * hr + 1] * mul);
      if (tig == 0)
        lse[(size_t)bh * Lq + i] =
            sum == 0.f ? NEG_INF : (m[hr] + log2f(sum)) * 0.69314718055994531f;
    }
  }
}

template <int D, class Mask>
cudaError_t launch_fwd_tma(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int Lq, int Lk, int H,
                           int Hkv, float scale, int causal, Mask mask,
                           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::tmap_rows(&tq, q, B, Lq, H, D, TMA_BM);
  if (err == cudaSuccess)
    err = sm90::tmap_rows(&tk, k, B, Lk, Hkv, D, TMA_BN);
  if (err == cudaSuccess)
    err = sm90::tmap_rows(&tv, v, B, Lk, Hkv, D, TMA_BN);
  if (err != cudaSuccess) return err;
  const size_t smem = tma_smem_bytes<D>(mask);
  err = cudaFuncSetAttribute(fwd_tma_kernel<D, Mask>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + TMA_BM - 1) / TMA_BM);
  fwd_tma_kernel<D, Mask><<<grid, TMA_THREADS, smem, stream>>>(
      tq, tk, tv, (bf16*)o, lse, Lq, Lk, H, Hkv,
      scale * LOG2E, causal, mask);
  return cudaGetLastError();
}

}  // namespace fa
}  // namespace ptt
