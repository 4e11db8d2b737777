// The bf16 FA-2 backward for Hopper (sm_90a), under a column mask
// policy: K1dq / K1dkv (NoMask) and K6dq / K6dkv (ColumnMask) run these
// two templates. Both recompute P = exp(scale * Q K^T - lse) from the
// forward's row log-sum-exp; delta = rowsum(dO * O) comes from the
// caller. Two passes, each deterministic, no atomics: a dq pass and a
// dk/dv pass (3 + 4 products over the visible pairs, against the 5 of
// a fused pass that would sum dq with atomics in no fixed order).
//
// What bounds them on the H100: operations, 6 D flops a visible pair
// (dq) and 8 D (dk/dv) at the dense bf16 tensor-core rate; only wgmma
// reaches it. Next come the exponentials (one MUFU op an entry) and the
// elementwise work on S and dP, then the copies.
//
// Both are built like the forward (flash_attention_fwd_sm90.cuh): 384
// threads, one block an SM; warpgroup 0 produces (setmaxnreg 24, one
// thread issues TMA loads of 128-byte-swizzled tiles into rings of
// shared memory guarded by "full" / "empty" mbarriers), warpgroups 1
// and 2 consume (setmaxnreg 240), 64 rows each, with wgmma m64nNk16:
// the scores with both operands K-major (dk/dv: both in shared memory;
// dq: A from registers), and the updates with the bf16 A operand
// converted in registers from a float32 accumulator (the reference's
// p.astype / ds.astype) and the B operand read through the descriptor's
// transpose bit, never copied transposed.
//
// dq (K1dq, K6dq): one block per (batch * head, 128-row q tile), the q
// tiles launched from the last (the longest causal walk) down. Q and dO
// are loaded once; K and V tiles of 64 rows stream through two 3-slot
// rings, filled by the forward's producer (produce_kv). Per kv tile a
// consumer forms S = Q K^T and dP = dO V^T (32 + 32 accumulators), P =
// exp2(S * scale log2 e - lse log2 e) (one FFMA and ex2), dS = P (dP -
// delta) scale, and dq += dS K (64 accumulators at D 128). The V slot is
// released once dP is read, the K slot once dS K is waited for; tile
// t's dS K is issued between tile t + 1's S and dP, so P's exponentials
// wait for S alone (that order took dq from 0.84 to 0.61 ms on the
// training shape). Q and dO never change in a block: each consumer
// keeps its rows of both as bf16 A fragments in registers (ldmatrix
// from the swizzled tiles, once), so S and dP read only K and V from
// shared memory (an SS m64n64 product reads ~128 bytes a clock at the
// full rate, the bandwidth of shared memory). Under causal a consumer
// stops at its own diagonal.
//
// dk/dv (K1dkv, K6dkv): one block per (batch * kv head, 128-row kv
// tile), the kv tiles ascending (under causal tile 0 sees every q
// tile: heaviest first). K and V are loaded once; the producer streams
// the (query head of the group, 64-row q tile) items through a 3-slot
// ring: Q, dO (TMA), and, from its 32 lanes' plain loads, the item's
// lse (times log2 e) and delta rows, zero past Lq (a float32 [B H, Lq]
// row stride is no TMA stride when Lq % 4 != 0), and under a column
// mask that head's bounds of the 128 kv columns and one flag per
// 64-column half. The group's sum stays in one block: deterministic.
// Per item a consumer forms S^T = K Q^T and dP^T = V dO^T, P^T and dS^T,
// and dV += P^T dO, dK += dS^T Q (64 + 64 accumulators at D 128), then
// releases the slot. A consumer whose 64 kv rows the item's q tile
// cannot see (causal, or past Lk) skips its products.
//
// Masking only where needed: a tile takes the per-entry predicate
// (column < Lk, row < Lq (dk/dv), causal j <= i, the column mask's
// sees()) only if it holds the causal diagonal of the consumer's rows,
// column Lk - 1 or row Lq - 1, or (column mask) a column that hides a
// row of the q tile. Interior tiles take none. A masked entry has P = 0
// exactly, never exp2 of the lse: a row that sees nothing has lse =
// NEG_INF, and every tile holding it is masked by one of those tests,
// so its dq is exactly 0 and it adds nothing to dk or dv.
//
// The tile walks: dq takes the live 64-column kv tiles (K6: live iff
// the tile summary says so, init_live<1>); dk/dv jumps each head's
// range of dead q tiles, the intersection of its two 64-column halves'
// ranges (init_dead<2>). K1 and K6 walk the same tiles in the same
// order through one body, so a mask that hides nothing gives K1's bits.
#pragma once

#include "flash_attention_fwd_sm90.cuh"

namespace ptt {
namespace fa {

constexpr int DQ_BM = 128;    // q rows of a dq block
constexpr int DQ_BN = 64;     // kv rows of a dq ring slot
constexpr int DQ_STAGES = 3;
constexpr int DKV_BN = 128;   // kv rows of a dk/dv block
constexpr int DKV_BM = 64;    // q rows of a dk/dv ring slot
constexpr int DKV_STAGES = 3;
constexpr int DKV_NBS = 2 * DKV_BN + 2;   // bounds + two flags of a slot

// descriptor of k16 step kk of a K-major operand whose rows r0.. lie in
// a tile of ROWS rows (its 64-column atoms ROWS x 64)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(const bf16* tile, int r0,
                                                int kk) {
  return sm90::desc_sw128(
      tile + ((kk / 4) * ROWS + r0) * TMA_ATOM + (kk % 4) * 16, 0, 1024);
}

// descriptor of k16 step kk (rows 16 kk..) of an MN-major operand: a
// tile of ROWS reduction rows, read with the transpose bit
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(const bf16* tile, int kk) {
  return sm90::desc_sw128(tile + kk * 16 * TMA_ATOM,
                          ROWS * TMA_ATOM * sizeof(bf16), 1024);
}

// 64 rows of a consumer's [64 x D] accumulator -> rows r < L of dst
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[D / 2],
                                           int row0, int b, int L, int NH,
                                           int hh) {
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + 8 * hr;
    if (r >= L) continue;
    bf16* o = dst + row_off<D>(b, r, L, NH, hh) + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  }
}

template <int D, class Mask>
size_t dq_smem_bytes(const Mask& mask) {
  constexpr size_t q = (size_t)DQ_BM * D * sizeof(bf16);
  constexpr size_t kv = (size_t)DQ_BN * D * sizeof(bf16);
  return 1024 + 2 * q + 2 * DQ_STAGES * kv +
         (1 + 4 * DQ_STAGES) * sizeof(uint64_t) +
         sizeof(int) * (Mask::kOn ? DQ_STAGES * (2 * DQ_BN + 1) : 0) +
         sizeof(unsigned) * mask.live_words();
}

template <int D, class Mask>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    dq_tma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int Lq, int Lk, int H, int Hkv, float scale,
                  float scale_log2, int causal, Mask mask) {
  using namespace sm90;
  constexpr int BM = DQ_BM, BN = DQ_BN, S = DQ_STAGES, NA = D / TMA_ATOM;
  constexpr int QT = NA * BM * TMA_ATOM;       // elements of a Q tile
  constexpr int KT = NA * BN * TMA_ATOM;       // elements of a K tile
  constexpr int NBS = 2 * BN + 1;
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  extern __shared__ unsigned char fa_raw[];
  unsigned char* base = fa_raw + ((1024 - (smem_u32(fa_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);    // [NA][128][64] swizzled
  bf16* dOs = Qs + QT;                         // [NA][128][64]
  bf16* Ks = dOs + QT;                         // [S][NA][64][64]
  bf16* Vs = Ks + S * KT;                      // [S][NA][64][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + S * KT);
  uint64_t* k_full = q_full + 1;               // [S] each
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;
  int* Bs = reinterpret_cast<int*>(v_empty + S);   // [S][NBS] (column mask)
  unsigned* live =
      reinterpret_cast<unsigned*>(Bs + (Mask::kOn ? S * NBS : 0));

  const int q_last = min(q0 + BM, Lq) - 1;
  const int k_end = causal ? min(Lk, q_last + 1) : Lk;
  const int n_kt = (k_end + BN - 1) / BN;
  const int mrow = mask.row(b, h, H);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 8);   // lane 0 of each consumer warp
      mbar_init(v_empty + s, 8);
    }
    fence_barrier_init();
  }
  mask.template init_live<BN / TILE>(live, mrow, n_kt, q0, q_last);
  __syncthreads();

  const int wg = __shfl_sync(FULL_MASK, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------ producer
    regs_dealloc<24>();
    if (__shfl_sync(FULL_MASK, threadIdx.x / 32, 0) == 0) {
      if (threadIdx.x == 0) {
        prefetch_tmap(&tq);
        prefetch_tmap(&tdo);
        prefetch_tmap(&tk);
        prefetch_tmap(&tv);
        mbar_expect_tx(q_full, 2 * QT * sizeof(bf16));
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(Qs + a * BM * TMA_ATOM, &tq, q_full, a * TMA_ATOM, h,
                      q0, b);
          tma_load_4d(dOs + a * BM * TMA_ATOM, &tdo, q_full, a * TMA_ATOM,
                      h, q0, b);
        }
      }
      produce_kv<D, BN, S>(&tk, &tv, Ks, Vs, k_full, v_full, k_empty,
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
    float lse2[2], dl[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = row0 + 8 * hr;
      lse2[hr] = i < Lq ? lse[(size_t)bh * Lq + i] * LOG2E : 0.f;
      dl[hr] = i < Lq ? delta[(size_t)bh * Lq + i] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float sc[32], dp[32];
    uint32_t da[4][4];                           // dS as bf16 A fragments
    uint32_t qa[D / 16][4], doa[D / 16][4];      // Q, dO: the same, once
    auto issue_s = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs(sc, qa[kk], desc_kmajor<BN>(Ks + s * KT, 0, kk), kk > 0);
      wgmma_commit();
    };
    auto issue_dp = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs(dp, doa[kk], desc_kmajor<BN>(Vs + s * KT, 0, kk), kk > 0);
      wgmma_commit();
    };
    auto issue_dq = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_tb(acc, da[kk], desc_mnmajor<BN>(Ks + s * KT, kk));
      wgmma_commit();
    };
    // P in sc once S has been waited for
    auto form_p = [&](int t, int s) {
      const int k0 = t * BN;
      const int* bs = Bs + s * NBS;
      const bool edge = (causal && k0 + BN - 1 > wg_first) ||
                        k0 + BN > Lk || wg_first + 64 > Lq ||
                        (Mask::kOn && bs[2 * BN]);
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
                      ? ex2(fmaf(x, scale_log2, -lse2[hr]))
                      : 0.f;
            }
          }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          sc[e] = ex2(fmaf(sc[e], scale_log2, -lse2[(e >> 1) & 1]));
      }
    };
    // dS into da once dP has been waited for (and the dS K that read da
    // before); the V slot is free after that
    auto form_ds = [&](int s) {
      fence_regs(dp);
      warp_arrive(v_empty + s);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = sc[e] * (dp[e] - dl[(e >> 1) & 1]) * scale;
      pack_a(da, dp);
    };
    // this consumer's tiles: under causal none past its rows' diagonal
    // (consumer 0 sees nothing of the last tile), none if its rows lie
    // past Lq; the tiles only the other consumer needs are waited for
    // and released unread, in order, so the rings' phases stay in step
    const int wg_last = min(wg_first + 63, Lq - 1);
    const int n_mine = wg_first >= Lq ? 0
                       : causal   ? min(n_kt, wg_last / BN + 1)
                                  : n_kt;
    mbar_wait(q_full, 0);   // also when no tile is live: the copy ends
    int t = mask.next_live(live, 0, n_kt), it = 0;
    if (t < n_mine) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldsm_a_sw128<BM>(qa[kk], Qs, 64 * c + 16 * warp, kk);
        ldsm_a_sw128<BM>(doa[kk], dOs, 64 * c + 16 * warp, kk);
      }
      mbar_wait(k_full, 0);
      mbar_wait(v_full, 0);
      wgmma_fence();
      issue_s(0);
      issue_dp(0);
      wgmma_wait<1>();
      fence_regs(sc);
      form_p(t, 0);
      wgmma_wait<0>();
      form_ds(0);
      for (t = mask.next_live(live, t + 1, n_kt), it = 1; t < n_mine;
           t = mask.next_live(live, t + 1, n_kt), ++it) {
        const int s = it % S, sp = (it - 1) % S;
        const uint32_t ph = (it / S) & 1;
        mbar_wait(k_full + s, ph);
        mbar_wait(v_full + s, ph);
        wgmma_fence();
        issue_s(s);
        issue_dq(sp);
        issue_dp(s);
        wgmma_wait<2>();
        fence_regs(sc);
        form_p(t, s);
        wgmma_wait<1>();
        fence_regs(acc);
        warp_arrive(k_empty + sp);
        wgmma_wait<0>();
        form_ds(s);
      }
      const int sp = (it - 1) % S;
      wgmma_fence();
      issue_dq(sp);
      wgmma_wait<0>();
      fence_regs(acc);
      warp_arrive(k_empty + sp);
    }
    for (; t < n_kt; t = mask.next_live(live, t + 1, n_kt), ++it) {
      const int s = it % S;
      const uint32_t ph = (it / S) & 1;
      mbar_wait(k_full + s, ph);
      mbar_wait(v_full + s, ph);
      warp_arrive(k_empty + s);
      warp_arrive(v_empty + s);
    }
    store_rows<D>(dq, acc, row0, b, Lq, H, h);
  }
}

template <int D, class Mask>
size_t dkv_smem_bytes(const Mask& mask, int rep) {
  constexpr size_t kv = (size_t)DKV_BN * D * sizeof(bf16);
  constexpr size_t q = (size_t)DKV_BM * D * sizeof(bf16);
  return 1024 + 2 * kv + 2 * DKV_STAGES * q +
         (1 + 2 * DKV_STAGES) * sizeof(uint64_t) +
         sizeof(float) * DKV_STAGES * 2 * DKV_BM +
         sizeof(int) * (Mask::kOn ? DKV_STAGES * DKV_NBS : 0) +
         sizeof(int) * mask.dead_ints(rep);
}

template <int D, class Mask>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    dkv_tma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int Lq, int Lk, int H, int Hkv,
                   float scale, float scale_log2, int causal, Mask mask) {
  using namespace sm90;
  constexpr int BN = DKV_BN, BM = DKV_BM, S = DKV_STAGES, NA = D / TMA_ATOM;
  constexpr int KT = NA * BN * TMA_ATOM;       // elements of a K tile
  constexpr int QT = NA * BM * TMA_ATOM;       // elements of a Q tile
  constexpr int NBS = DKV_NBS;
  const int bhk = blockIdx.x, kt = blockIdx.y, k0 = kt * BN;
  const int b = bhk / Hkv, hk = bhk % Hkv, rep = H / Hkv;
  extern __shared__ unsigned char fa_raw[];
  unsigned char* base = fa_raw + ((1024 - (smem_u32(fa_raw) & 1023)) & 1023);
  bf16* Ks = reinterpret_cast<bf16*>(base);    // [NA][128][64] swizzled
  bf16* Vs = Ks + KT;                          // [NA][128][64]
  bf16* Qs = Vs + KT;                          // [S][NA][64][64]
  bf16* dOs = Qs + S * QT;                     // [S][NA][64][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dOs + S * QT);
  uint64_t* full = kv_full + 1;                // [S]
  uint64_t* empty = full + S;                  // [S]
  float* Rows = reinterpret_cast<float*>(empty + S);   // [S][lse | delta]
  int* Bs = reinterpret_cast<int*>(Rows + S * 2 * BM);  // [S][NBS]
  int* dead = Bs + (Mask::kOn ? S * NBS : 0);           // [2 rep]

  // causal: row i sees column j iff j <= i, so q tiles before the one
  // holding row k0 see nothing of this kv tile
  const int qt0 = causal ? k0 / BM : 0;
  const int n_qt = max(0, (Lq + BM - 1) / BM - qt0);   // q tiles a head
  const int n_items = rep * n_qt;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 32);    // every producer lane
      mbar_init(empty + s, 8);    // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  mask.template init_dead<BN / TILE>(dead, b, hk, rep, H, kt, Lq);
  __syncthreads();

  const int wg = __shfl_sync(FULL_MASK, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------ producer
    regs_dealloc<24>();
    if (__shfl_sync(FULL_MASK, threadIdx.x / 32, 0) == 0) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        prefetch_tmap(&tq);
        prefetch_tmap(&tdo);
        prefetch_tmap(&tk);
        prefetch_tmap(&tv);
        mbar_expect_tx(kv_full, 2 * KT * sizeof(bf16));
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(Ks + a * BN * TMA_ATOM, &tk, kv_full, a * TMA_ATOM, hk,
                      k0, b);
          tma_load_4d(Vs + a * BN * TMA_ATOM, &tv, kv_full, a * TMA_ATOM, hk,
                      k0, b);
        }
      }
      int it = 0;
      for (int u = mask.next_item(dead, 0, n_qt, qt0, n_items); u < n_items;
           u = mask.next_item(dead, u + 1, n_qt, qt0, n_items), ++it) {
        const int s = it % S;
        const int h = hk * rep + u / n_qt, q0 = (qt0 + u % n_qt) * BM;
        const size_t row = ((size_t)b * H + h) * Lq;
        mbar_wait(empty + s, ((it / S) & 1) ^ 1);
        float* rs = Rows + s * 2 * BM;
        for (int r = lane; r < BM; r += 32) {
          const bool ok = q0 + r < Lq;
          rs[r] = ok ? lse[row + q0 + r] * LOG2E : 0.f;
          rs[BM + r] = ok ? delta[row + q0 + r] : 0.f;
        }
        if (Mask::kOn) {
          int* bs = Bs + s * NBS;
          const int mrow = mask.row(b, h, H), q_last = min(q0 + BM, Lq) - 1;
          const bool hides0 =
              mask.template load_bounds<64>(bs, mrow, k0, q0, q_last);
          const bool hides1 = mask.template load_bounds<64>(
              bs + 128, mrow, k0 + 64, q0, q_last);
          if (lane == 0) {
            bs[2 * BN] = hides0;
            bs[2 * BN + 1] = hides1;
          }
        }
        // each lane's arrival releases its own writes above; lane 0's
        // also counts the copies' bytes
        if (lane == 0) {
          mbar_expect_tx(full + s, 2 * QT * sizeof(bf16));
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            tma_load_4d(Qs + s * QT + a * BM * TMA_ATOM, &tq, full + s,
                        a * TMA_ATOM, h, q0, b);
            tma_load_4d(dOs + s * QT + a * BM * TMA_ATOM, &tdo, full + s,
                        a * TMA_ATOM, h, q0, b);
          }
        } else {
          mbar_arrive(full + s);
        }
      }
    }
  } else {
    // -------------------------------------------------------- consumers
    regs_alloc<240>();
    const int c = wg - 1;                        // 64-row half of the tile
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int tig = lane % 4;
    const int kc = k0 + 64 * c;                  // this consumer's kv rows
    const int row0 = kc + 16 * warp + lane / 4;  // rows +0, +8
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;
    float st[32], dpt[32];
    uint32_t pa[4][4], da[4][4];
    mbar_wait(kv_full, 0);   // also when no item is live: the copy ends
    int it = 0;
    for (int u = mask.next_item(dead, 0, n_qt, qt0, n_items); u < n_items;
         u = mask.next_item(dead, u + 1, n_qt, qt0, n_items), ++it) {
      const int s = it % S;
      const int q0 = (qt0 + u % n_qt) * BM;
      mbar_wait(full + s, (it / S) & 1);
      if (kc >= Lk || (causal && q0 + BM - 1 < kc)) {
        warp_arrive(empty + s);   // no row of the q tile sees these rows
        continue;
      }
      const bf16* qs = Qs + s * QT;
      const bf16* dos = dOs + s * QT;
      const float* rs = Rows + s * 2 * BM;
      const int* bs = Bs + s * NBS + 128 * c;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(st, desc_kmajor<BN>(Ks, 64 * c, kk),
                 desc_kmajor<BM>(qs, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt, desc_kmajor<BN>(Vs, 64 * c, kk),
                 desc_kmajor<BM>(dos, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);
      // P^T: row j (kv) of st, column ic (q row q0 + ic)
      const bool edge = (causal && kc + 63 > q0) || kc + 64 > Lk ||
                        q0 + BM > Lq ||
                        (Mask::kOn && Bs[s * NBS + 2 * BN + c]);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ic = 8 * j + 2 * tig + e, i = q0 + ic;
            const float l2 = rs[ic];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int jr = row0 + 8 * hr;
              float& x = st[4 * j + 2 * hr + e];
              x = (i < Lq && jr < Lk && (!causal || jr <= i) &&
                   mask.template sees<64>(bs, jr - kc, i))
                      ? ex2(fmaf(x, scale_log2, -l2))
                      : 0.f;
            }
          }
      } else {
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float l2 = rs[8 * j + 2 * tig + e];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float& x = st[4 * j + 2 * hr + e];
              x = ex2(fmaf(x, scale_log2, -l2));
            }
          }
      }
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = rs[BM + 8 * j + 2 * tig + e];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int x = 4 * j + 2 * hr + e;
            dpt[x] = st[x] * (dpt[x] - d) * scale;   // dS^T
          }
        }
      pack_a(pa, st);
      pack_a(da, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs_tb(dv_acc, pa[kk], desc_mnmajor<BM>(dos, kk));
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_rs_tb(dk_acc, da[kk], desc_mnmajor<BM>(qs, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      warp_arrive(empty + s);
    }
    store_rows<D>(dk, dk_acc, row0, b, Lk, Hkv, hk);
    store_rows<D>(dv, dv_acc, row0, b, Lk, Hkv, hk);
  }
}

template <int D, class Mask>
cudaError_t launch_dq_tma(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int Lq,
                          int Lk, int H, int Hkv, float scale, int causal,
                          Mask mask, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::tmap_rows(&tq, q, B, Lq, H, D, DQ_BM);
  if (err == cudaSuccess)
    err = sm90::tmap_rows(&tdo, dout, B, Lq, H, D, DQ_BM);
  if (err == cudaSuccess)
    err = sm90::tmap_rows(&tk, k, B, Lk, Hkv, D, DQ_BN);
  if (err == cudaSuccess)
    err = sm90::tmap_rows(&tv, v, B, Lk, Hkv, D, DQ_BN);
  if (err != cudaSuccess) return err;
  const size_t smem = dq_smem_bytes<D>(mask);
  err = cudaFuncSetAttribute(dq_tma_kernel<D, Mask>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + DQ_BM - 1) / DQ_BM);
  dq_tma_kernel<D, Mask><<<grid, TMA_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, (bf16*)dq, Lq, Lk, H, Hkv, scale,
      scale * LOG2E, causal, mask);
  return cudaGetLastError();
}

template <int D, class Mask>
cudaError_t launch_dkv_tma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv, int B,
                           int Lq, int Lk, int H, int Hkv, float scale,
                           int causal, Mask mask, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::tmap_rows(&tq, q, B, Lq, H, D, DKV_BM);
  if (err == cudaSuccess)
    err = sm90::tmap_rows(&tdo, dout, B, Lq, H, D, DKV_BM);
  if (err == cudaSuccess)
    err = sm90::tmap_rows(&tk, k, B, Lk, Hkv, D, DKV_BN);
  if (err == cudaSuccess)
    err = sm90::tmap_rows(&tv, v, B, Lk, Hkv, D, DKV_BN);
  if (err != cudaSuccess) return err;
  const size_t smem = dkv_smem_bytes<D>(mask, H / Hkv);
  err = cudaFuncSetAttribute(dkv_tma_kernel<D, Mask>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (Lk + DKV_BN - 1) / DKV_BN);
  dkv_tma_kernel<D, Mask><<<grid, TMA_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, (bf16*)dk, (bf16*)dv, Lq, Lk, H, Hkv,
      scale, scale * LOG2E, causal, mask);
  return cudaGetLastError();
}

}  // namespace fa
}  // namespace ptt
