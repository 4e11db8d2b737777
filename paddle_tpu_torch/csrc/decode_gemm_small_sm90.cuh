// The second bf16 body of the fused decode-tick projections for Hopper
// (sm_90a), for small weights: K3a (norm -> 1..3 projections) and K3b
// (activation -> projection + residual) at GPT's widths (d 1024: q/k/v
// 1024 -> 3072, the MLP's 1024 -> 4096 and 4096 -> 1024, the output
// projection 1024 -> 1024). Included by norm_matmul.cu and
// matmul_residual.cu beside the stream-K body of decode_gemm_sm90.cuh,
// whose pieces (the activation pre-pass, the tensor-map cache) it shares;
// every mode, rounding order and C interface is that body's.
//
// Replaces, as that body does: paddle_tpu/ops/pallas/decode_fused.py,
// _norm_mm_kernel (call :300) and _mm_res_kernel (call :335).
//
// What bounds it on the H100: bytes, the weights (2.1-8.4 MB a call at
// GPT's widths, 0.6-2.5 us at 3.35 TB/s) and the rows every column tile
// reads again. Why a second body: at these widths the stream-K body cut
// each 128-column segment of 16 or 64 slices into 4 to 16 pieces, and
// every piece but one wrote a float32 partial of up to 96 KB to a
// workspace that one block then summed alone, behind a flag: at GPT's
// fc2 11.5 MB of partials against 8.4 MB of weights.
//
// Design:
// - One output tile (SPLIT_BN = 128 columns of one projection, all R <=
//   MAX_MG x 64 rows as MG m64 row groups) a thread-block cluster of
//   SPLIT blocks. Block s of the cluster reduces the K slices (64 deep)
//   [s per, (s + 1) per), per = ceil(nk / SPLIT). The grid (SPLIT,
//   tiles) is one wave.
// - A block: a producer warpgroup (one thread issues TMA: the weight tile
//   as two boxes of 64 x 64, evict-first; the rows as one box of 64
//   columns x MG x 64 rows, evict-last, zeros past R) into a ring of
//   stages, and MG consumer warpgroups that read their row group's A
//   fragments by ldmatrix and issue wgmma m64n128k16 with A from
//   registers, the next slice's fragments read while the products run.
// - The rows come ready from a pre-pass that the main kernel is launched
//   behind by programmatic dependent launch (the producer loads the
//   first stages' weights, then waits for it): K3a's norm (normalize,
//   into the call's workspace) or K3b's swiglu / gelu_tanh (the stream-K
//   body's activate), once an element. It beat, on GPT's q/k/v at 136
//   rows on the H100, the stream-K body's statistics pre-pass with the
//   norm applied to A fragments in registers (0.0127 against 0.0170 ms:
//   there each slice waited on its gamma / beta loads) and the cluster
//   taking the statistics itself, each block its K slice summed over
//   distributed shared memory (0.0226); the pre-pass costs 0.002-0.003
//   ms a call.
// - The cluster's sum, in place of the workspace: every block writes its
//   float32 accumulators, in the register layout, to its own shared
//   memory (the ring, free by then); after a cluster barrier block s
//   takes the tile's 8-column groups [s JS, (s + 1) JS), JS = ceil(16 /
//   SPLIT), adds the SPLIT partials read over distributed shared memory
//   in rank order 0 .. SPLIT - 1, and runs the epilogue: the product
//   rounded to bf16, plus the bias (rounded), plus the residual (rounded),
//   stored as bf16 pairs. A second barrier keeps every block's shared
//   memory alive until its peers have read it. No partials in device
//   memory, no flags, no atomics: the order of every sum is fixed by the
//   shape, so two calls give the same bits.
// - The split is a function of K and the widths alone (split_of): the
//   largest SPLIT <= 8 that gives every block at least one slice with
//   tiles x SPLIT <= SPLIT_BLOCKS (96). GPT: q/k/v 24 tiles x 4, fc1 32 x
//   3, out_proj and fc2 8 x 8. Measured (tools/flash_variants.py --only
//   k3 --sweep, H100): 128 blocks in clusters of 4 ran GPT's fc1 in
//   0.0217 ms at 136 rows against 0.0157 at 96 (64 blocks: 0.0162);
//   64-column tiles (twice the rows' bytes a weight byte) won q/k/v and
//   out_proj at 136 rows by 5-9 % and lost at 4 and 8 rows and on fc1.
// - Which body a bf16 call takes is a shape rule too (body_of, reported
//   by ptt_decode_gemm_body): this one for one row block (R <= 192) over
//   weights of at most SPLIT_MAX_WEIGHTS elements, the stream-K body
//   otherwise (Llama-3-8B's and Qwen2-7B's projections, 12.8-58.7 M
//   elements, and every tick past 192 rows).
#pragma once

#include <cooperative_groups.h>

#include "decode_gemm_sm90.cuh"

// the shape rule's bounds; a build may move them to time both bodies and
// other splits on the same shapes (tools/flash_variants.py --only k3
// --sweep)
#ifndef PTT_DG_SPLIT_MAX_WEIGHTS
#define PTT_DG_SPLIT_MAX_WEIGHTS (1 << 23)
#endif
#ifndef PTT_DG_SPLIT_BN   // the split body's column tile: 128 or 64
#define PTT_DG_SPLIT_BN 128
#endif
#ifndef PTT_DG_SPLIT_BLOCKS   // blocks a split call aims at
#define PTT_DG_SPLIT_BLOCKS 96
#endif

namespace ptt {
namespace dg90 {
namespace {

namespace cg = cooperative_groups;

constexpr int SPLIT_BN = PTT_DG_SPLIT_BN;
constexpr int SPLIT_MAX = 8;          // blocks of a cluster (portable)
constexpr int SPLIT_BLOCKS = PTT_DG_SPLIT_BLOCKS;   // one wave
constexpr long SPLIT_MAX_WEIGHTS = PTT_DG_SPLIT_MAX_WEIGHTS;
constexpr int BODY_STREAM_K = 0, BODY_SPLIT_K = 1;

template <int MG>
struct SplitCfg {
  static constexpr int THREADS = Cfg<MG>::THREADS;
  static constexpr int B_ATOMS = SPLIT_BN / 64;
  static constexpr int STAGE_ELEMS = (B_ATOMS + MG) * ATOM;   // B, then A
  static constexpr int STAGE_BYTES = STAGE_ELEMS * 2;
  static constexpr int STAGES =
      RING_BYTES / STAGE_BYTES < 8 ? RING_BYTES / STAGE_BYTES : 8;
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
  static constexpr int JN = SPLIT_BN / 8;   // 8-column groups of a tile
  static_assert(MG * JN * 128 * 16 <= STAGES * STAGE_BYTES,
                "the partials fit the ring");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// a call's split: blocks a cluster, column tiles, slices a block
struct Split {
  int split, tiles, per;
};

// the split of a call: a function of K and the widths alone
inline Split split_of(int K, const int* N, int nw) {
  int tiles = 0;
  for (int i = 0; i < nw; ++i) tiles += cdiv(N[i], SPLIT_BN);
  const int nk = cdiv(K, BK);
  int split = 1;
  for (int s = 2; s <= SPLIT_MAX; ++s)
    if ((long)tiles * s <= SPLIT_BLOCKS && cdiv(nk, cdiv(nk, s)) == s)
      split = s;
  return Split{split, tiles, cdiv(nk, split)};
}

// the body of a bf16 call: a function of R, K and the widths alone
inline int body_of(int R, int K, const int* N, int nw) {
  long weights = 0;
  for (int i = 0; i < nw; ++i) weights += (long)K * N[i];
  return R <= MAX_MG * 64 && weights <= SPLIT_MAX_WEIGHTS ? BODY_SPLIT_K
                                                          : BODY_STREAM_K;
}

// every thread of the cluster's blocks: release this block's shared-memory
// writes, acquire its peers'
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::
                   : "memory");
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// grid (SPLIT, tiles), clusters (SPLIT, 1, 1), SplitCfg::THREADS threads,
// SplitCfg::SMEM bytes. ta: 2-D map over the rows [R, K], box (64, MG x
// 64); tb[i]: 2-D map over W_i [K, N_i], box (64, 64). DEP: the rows come
// from the pre-pass the kernel was launched behind.
template <int MG, bool DEP>
__global__ void __launch_bounds__(SplitCfg<MG>::THREADS, 1)
    decode_gemm_split(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb0,
                      const __grid_constant__ CUtensorMap tb1,
                      const __grid_constant__ CUtensorMap tb2,
                      const Params p) {
  using namespace sm90;
  using C = SplitCfg<MG>;
  constexpr int STAGES = C::STAGES, JN = C::JN, BN = SPLIT_BN;
  extern __shared__ unsigned char dgs_raw[];
  unsigned char* base =
      dgs_raw + ((1024 - (smem_u32(dgs_raw) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_ELEMS);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * MG);   // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int rank = blockIdx.x, tile = blockIdx.y;
  const int k0 = rank * p.per, n = max(0, min(p.nk, k0 + p.per) - k0);
  const int proj = tile < p.t_end[0] ? 0 : (tile < p.t_end[1] ? 1 : 2);
  const int c0 = (tile - (proj ? p.t_end[proj - 1] : 0)) * BN;
  const int wg = __shfl_sync(FULL_MASK, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if constexpr (Cfg<MG>::REALLOC) regs_dealloc<24>();
    if (threadIdx.x == 0) {
      prefetch_tmap(&ta);
      const CUtensorMap* tb = proj == 0 ? &tb0 : (proj == 1 ? &tb1 : &tb2);
      prefetch_tmap(tb);
      const bool two = BN == 128 && c0 + 64 < p.N[proj];
      const uint64_t stream_once = l2_evict_first(), keep = l2_evict_last();
      // slice i's weights (the stage's expected bytes, the rows' included)
      auto load_b = [&](int i) {
        const int s = i % STAGES;
        bf16* st = ring + s * C::STAGE_ELEMS;
        mbar_expect_tx(full + s, ((two ? 2 : 1) + MG) * ATOM * 2);
        tma_load_2d(st, tb, full + s, c0, (k0 + i) * BK, stream_once);
        if (two)
          tma_load_2d(st + ATOM, tb, full + s, c0 + 64, (k0 + i) * BK,
                      stream_once);
      };
      const int pre = DEP ? min(STAGES, n) : 0;
      for (int i = 0; i < pre; ++i) load_b(i);   // during the pre-pass
      if (DEP) grid_dep_wait();
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= pre) {
          mbar_wait(empty + s, ((i / STAGES) & 1) ^ 1);
          load_b(i);
        }
        tma_load_2d(ring + s * C::STAGE_ELEMS + C::B_ATOMS * ATOM, &ta,
                    full + s, (k0 + i) * BK, 0, keep);
      }
    }
    cluster_sync();   // the partials are written
    cluster_sync();   // and read
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (Cfg<MG>::REALLOC) regs_alloc<Cfg<MG>::REGS_CONSUMER>();
    const int c = wg - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, q = lane % 4;
    const int ra = 64 * c + 16 * warp + lane / 4;   // rows ra, ra + 8
    const bool live = 64 * c + 16 * warp < p.R;     // the warp has rows
    float acc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    // slice i's A fragments into a
    auto fetch = [&](uint32_t (&a)[BK / 16][4], int i) {
      const int s = i % STAGES;
      mbar_wait(full + s, (i / STAGES) & 1);
      const bf16* rows =
          ring + s * C::STAGE_ELEMS + (C::B_ATOMS + c) * ATOM;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        ldsm_a_sw128<64>(a[kk], rows, 16 * warp, kk);
    };
    // slice i's products on a, the next slice's fragments into b while
    // they run, then the stage back to the producer
    auto step = [&](uint32_t (&a)[BK / 16][4], uint32_t (&b)[BK / 16][4],
                    int i) {
      const int s = i % STAGES;
      const bf16* wt = ring + s * C::STAGE_ELEMS;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_tb(acc, a[kk],
                    desc_sw128(wt + kk * 16 * 64, ATOM * 2, 1024));
      wgmma_commit();
      if (i + 1 < n) fetch(b, i + 1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_a(a);
      warp_arrive(empty + s);
    };
    uint32_t a0[BK / 16][4], a1[BK / 16][4];
    if (n > 0) fetch(a0, 0);
    for (int i = 0; i < n; i += 2) {
      step(a0, a1, i);
      if (i + 1 < n) step(a1, a0, i + 1);
    }

    // ------------------------------------------------- the cluster's sum
    // partial slot (c, j, tid): columns 8 j + 2 q (+1) of rows ra, ra + 8
    float4* red = reinterpret_cast<float4*>(ring);
    bar_sync(1, 128 * MG);   // every consumer is done with the ring
    if (live) {
#pragma unroll
      for (int j = 0; j < JN; ++j)
        red[(c * JN + j) * 128 + tid] = make_float4(
            acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
    cluster_sync();
    const int S = gridDim.x, JS = cdiv(JN, S);
    const int j0 = min(JN, rank * JS), j1 = min(JN, j0 + JS);
    if (live && j0 < j1) {
      cg::cluster_group cluster = cg::this_cluster();
      const int N = p.N[proj];
      bf16* out = p.out[proj];
      const bf16* bias = p.bias[proj];
      // 8 column groups at a time: their partials, bias and residual
      // loads all go out before the first store
      for (int jb = j0; jb < j1; jb += 8) {
        float4 v[8];
        uint32_t bv[8], rv[8][2];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = jb + jj;
          if (j >= j1) continue;
          const int slot = (c * JN + j) * 128 + tid;
          float4 t[SPLIT_MAX];
#pragma unroll
          for (int r = 0; r < SPLIT_MAX; ++r)
            if (r < S) t[r] = cluster.map_shared_rank(red, r)[slot];
          v[jj] = t[0];
#pragma unroll
          for (int r = 1; r < SPLIT_MAX; ++r)
            if (r < S) add4(v[jj], t[r]);
          const int col = c0 + 8 * j + 2 * q;
          bv[jj] = bias ? pair_at(bias, col, N) : 0u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = ra + 8 * h;
            rv[jj][h] = p.res && col < N && r < p.R
                            ? __ldg(reinterpret_cast<const uint32_t*>(
                                  p.res + (size_t)r * N + col))
                            : 0u;
          }
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = jb + jj, col = c0 + 8 * j + 2 * q;
          if (j >= j1 || col >= N) continue;
          const float2 b = bf2f(bv[jj]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = ra + 8 * h;
            if (r >= p.R) continue;
            float y0 = rbf(h ? v[jj].z : v[jj].x);
            float y1 = rbf(h ? v[jj].w : v[jj].y);
            if (bias) {
              y0 = rbf(y0 + b.x);
              y1 = rbf(y1 + b.y);
            }
            if (p.res) {
              const float2 res = bf2f(rv[jj][h]);
              y0 += res.x;
              y1 += res.y;
            }
            *reinterpret_cast<uint32_t*>(out + (size_t)r * N + col) =
                f2bf(y0, y1);
          }
        }
      }
    }
    cluster_sync();   // the peers have read this block's partials
  }
}

// 8 elements of a row normalised as norm_frags does: bf16(bf16((x - m) *
// rs) * gamma), then + beta rounded (ln with beta; m = 0 for rms)
__device__ __forceinline__ uint4 norm8(const uint4& xv, const uint4& gv,
                                       const uint4& bv, float m, float rs,
                                       bool beta_on) {
  const uint32_t* xp = reinterpret_cast<const uint32_t*>(&xv);
  const uint32_t* gp = reinterpret_cast<const uint32_t*>(&gv);
  const uint32_t* bp = reinterpret_cast<const uint32_t*>(&bv);
  uint4 w;
  uint32_t* o = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = bf2f(xp[e]);
    const uint32_t z = mul_bf2(f2bf((v.x - m) * rs, (v.y - m) * rs), gp[e]);
    if (beta_on) {
      const float2 zf = bf2f(z), b = bf2f(bp[e]);
      o[e] = f2bf(zf.x + b.x, zf.y + b.y);
    } else {
      o[e] = z;
    }
  }
  return w;
}

constexpr int NORM_ROWS = 8;    // rows a block of normalize, a warp each
constexpr int NORM_HELD = 8;    // 16-byte chunks a lane holds: K <= 2048

// one row of normalize by its warp; HELD: the row, gamma and beta read
// once into registers up front, else read again for each pass
template <bool HELD>
__device__ __forceinline__ void norm_row(const bf16* xr, bf16* yr,
                                         const bf16* gamma, const bf16* beta,
                                         int K, float eps, int ln) {
  const int lane = threadIdx.x % 32;
  const bool beta_on = beta != nullptr;
  constexpr int H = HELD ? NORM_HELD : 1;
  uint4 xv[H], gv[H], bv[H];
  auto ld = [](const bf16* p, int k) {
    return *reinterpret_cast<const uint4*>(p + k);
  };
  // f(chunk) over this lane's 16-byte chunks of x, k = 8 lane + 256 i
  auto each = [&](auto&& f) {
    if constexpr (HELD) {
#pragma unroll
      for (int i = 0; i < NORM_HELD; ++i)
        if (lane * 8 + i * 32 * 8 < K) f(xv[i]);
    } else {
      for (int k = lane * 8; k < K; k += 32 * 8) f(ld(xr, k));
    }
  };
  if constexpr (HELD) {
#pragma unroll
    for (int i = 0; i < NORM_HELD; ++i) {
      const int k = lane * 8 + i * 32 * 8;
      if (k < K) {
        xv[i] = ld(xr, k);
        gv[i] = ld(gamma, k);
        bv[i] = beta_on ? ld(beta, k) : make_uint4(0, 0, 0, 0);
      }
    }
  }
  float m = 0.f;
  if (ln) {
    float s = 0.f;
    each([&](const uint4& c) {
      float v[8];
      unpack8(c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[e];
    });
    m = warp_sum(s) / (float)K;
  }
  float ss = 0.f;
  each([&](const uint4& c) {
    float v[8];
    unpack8(c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = fmaf(v[e] - m, v[e] - m, ss);
  });
  const float rs = rsqrtf(warp_sum(ss) / (float)K + eps);
  if constexpr (HELD) {
#pragma unroll
    for (int i = 0; i < NORM_HELD; ++i) {
      const int k = lane * 8 + i * 32 * 8;
      if (k < K)
        *reinterpret_cast<uint4*>(yr + k) =
            norm8(xv[i], gv[i], bv[i], m, rs, beta_on);
    }
  } else {
    for (int k = lane * 8; k < K; k += 32 * 8)
      *reinterpret_cast<uint4*>(yr + k) = norm8(
          ld(xr, k), ld(gamma, k),
          beta_on ? ld(beta, k) : make_uint4(0, 0, 0, 0), m, rs, beta_on);
  }
}

// K3a's norm for the split body, once an element, into the rows the main
// kernel reads: y = bf16(bf16((x - mean) * rstd) * gamma), then + beta
// rounded (ln with beta): the plain version's rounding, the stream-K
// body's norm_frags. One warp a row; the statistics as row_stats takes
// them (ln: the mean, then the mean square of the centred row; rms: the
// mean square), from the row, gamma and beta held in registers up to K =
// 2048 (one read each, all issued at once). Lets the main kernel launch
// (programmatic dependent launch) before it ends.
__global__ void __launch_bounds__(NORM_ROWS * 32)
    normalize(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
              const bf16* __restrict__ beta, bf16* __restrict__ y, int R,
              int K, float eps, int ln) {
  grid_dep_launch();
  const int r = blockIdx.x * NORM_ROWS + threadIdx.x / 32;
  if (r >= R) return;
  const bf16* xr = x + (size_t)r * K;
  bf16* yr = y + (size_t)r * K;
  if (K <= NORM_HELD * 32 * 8)
    norm_row<true>(xr, yr, gamma, beta, K, eps, ln);
  else
    norm_row<false>(xr, yr, gamma, beta, K, eps, ln);
}

// ---------------------------------------------------------------- launch

// a call's split and tensor maps (plan_split)
struct SplitPlan {
  CUtensorMap maps[4];   // the rows, W_0 .. W_2
  int mg, dev;
  Split s;
};

template <int MG, bool DEP>
cudaError_t launch_split_mg(const SplitPlan& pl, const Params& p,
                            cudaStream_t stream) {
  using C = SplitCfg<MG>;
  auto kernel = decode_gemm_split<MG, DEP>;
  static unsigned long long ready = 0;   // the attribute set, a bit a device
  if (pl.dev >= 64 || !(ready >> pl.dev & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    if (pl.dev < 64) ready |= 1ull << pl.dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.s.split, pl.s.tiles);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.s.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = DEP ? 2 : 1;   // behind a pre-pass
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, pl.maps[0],
                                             pl.maps[1], pl.maps[2],
                                             pl.maps[3], p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the split body (DEP: its rows from the pre-pass it is launched behind)
template <bool DEP>
cudaError_t launch_split(const SplitPlan& pl, const Params& p,
                         cudaStream_t stream) {
  switch (pl.mg) {
    case 1: return launch_split_mg<1, DEP>(pl, p, stream);
    case 2: return launch_split_mg<2, DEP>(pl, p, stream);
    default: return launch_split_mg<3, DEP>(pl, p, stream);
  }
}

// A call's split and maps: x [R, K] the rows the main kernel reads; w[i]
// [K, N_i]; p's R, K, nw and N set by the caller, its schedule fields set
// here. Refuses what the body does not take: more than one row block.
inline cudaError_t plan_split(const void* x, const void* const* w, Params& p,
                              SplitPlan& pl) {
  if (p.R < 1 || p.R > MAX_MG * 64 || p.nw < 1 || p.nw > MAX_NW)
    return cudaErrorInvalidValue;
  pl.mg = cdiv(p.R, 64);
  pl.s = split_of(p.K, p.N, p.nw);
  p.nrb = 1;
  p.nk = cdiv(p.K, BK);
  p.per = pl.s.per;
  int tiles = 0;
  for (int i = 0; i < MAX_NW; ++i) {
    if (i < p.nw) tiles += cdiv(p.N[i], SPLIT_BN);
    p.t_end[i] = tiles;
  }
  sm_count(pl.dev);
  cudaError_t err = cached_map(&pl.maps[0], x, p.R, p.K, pl.mg * 64);
  for (int i = 0; i < p.nw && err == cudaSuccess; ++i)
    err = cached_map(&pl.maps[1 + i], w[i], p.K, p.N[i], 64);
  for (int i = p.nw; i < MAX_NW; ++i) pl.maps[1 + i] = pl.maps[1];
  return err;
}

}  // namespace
}  // namespace dg90
}  // namespace ptt
