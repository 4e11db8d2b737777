// The bf16 grouped matmuls of MoE for Hopper (sm_90a), forward and
// backward, over expert-sorted rows (the rows of group g are [start[g],
// start[g + 1]) of the exclusive cumsum of group_sizes [e]):
//
// - gmm_kernel, out[r] = lhs[r] @ B[g] in three layouts of B:
//   - B_KN, rhs [e, K, N] (the forward: K5's gmm on sorted rows, K4's
//     gather gmm that the backward recomputes, lhs[r] = x[src_rows[r]],
//     and K4's scatter, out[dst_rows[r]] = row r);
//   - B_SWIGLU, rhs [e, K, 2f] (K4's gather + swiglu): out[r] =
//     silu(lhs[r] @ rhs[g][:, :f]) * (lhs[r] @ rhs[g][:, f:]), [m, f];
//   - B_NK, rhs [e, N, K] contracted over its last dim (the backward:
//     K5's d(lhs), K4's transposed gather and transposed scatter);
// - tgmm, out[g] = lhs[rows of g]^T @ dy[rows of g], [e, K, N] (K5's
//   weight gradient of both expert matmuls).
//
// moe_gmm.cu runs every bf16 mode here except the forward modes at few
// rows a group (serving), which keep its mma.sync body.
//
// What bounds them on the H100: operations. A training step of 2 x 4096
// tokens, top-6 over 64 experts, gives each expert ~768 rows, so every
// product runs at ~300-800 flops per byte of its operands: above the
// ~295 where the dense bf16 tensor-core rate (989 TFLOP/s) is the limit,
// which only wgmma reaches. Inside the card, the tiles' L2 -> SM bytes
// and the output stores are what hold them below it.
//
// Design (persistent, warp-specialised, after CUTLASS's sm90 kernels):
// - One block an SM, 384 threads in three warpgroups. Warpgroup 0
//   produces (setmaxnreg 24; 56 for the gather's copiers), warpgroups 1
//   and 2 consume (240; 224), each owning 64 rows of a 128 x 256 output
//   tile (swiglu: 128 x 128 outputs from a 128 x 256 product) and issuing
//   wgmma m64n256k16 from 128-byte-swizzled shared memory. 256 columns
//   rather than 128 cut the L2 -> SM bytes a flop by a quarter (a 128 x
//   256 x 64 slice is 85 flops a byte, 128 x 128 x 64 64), and ran faster
//   in every backward mode, even where N = 1408 leaves the last column
//   tile half empty.
// - The tile schedule is computed on the device: every block scans
//   group_sizes (e <= 1024) into the groups' first rows and, for
//   gmm_kernel, each group's tile count, then walks the linear tile
//   index t = blockIdx.x, t += gridDim.x, mapping t to (group, column
//   tile, row tile) by a binary search over the cumulative counts.
//   Nothing is read back to the host. Row tiles run fastest inside a
//   (group, column tile), so blocks working at the same time share the
//   group's [256 x K] weight slice in L2 and the weights stream from
//   device memory about once. Rows no group owns ([sum, m)) come out as
//   zeros from "zero tiles" at the end of the schedule.
// - Operands reach shared memory through a 4-stage ring of 64-deep
//   reduction slices (48 KB a stage: 16 KB of A, 32 KB of B), each stage
//   with a "full" mbarrier (TMA completes its bytes) and an "empty" one
//   (the 8 consumer warps release it once the wgmma that read it has
//   been waited for). The ring runs on across tiles, so the producer
//   loads the next tile while the consumers store this one.
// - gmm_kernel's A, sorted or scatter: by TMA from a 2-D map over lhs
//   [m, K] at the tile's first row (rows past the group belong to the
//   next one, or lie past the groups: read, never stored). Gather: TMA
//   cannot gather rows, so the producer's 128 threads copy x[src_rows[r]]
//   with 16-byte cp.async straight into the swizzled layout (chunk c of
//   row r at chunk c ^ (r % 8)), wait for their copies LAG stages later,
//   fence the generic proxy against the async one that wgmma reads
//   through, and arrive on the stage's "full" mbarrier (129 arrivals: the
//   128 copiers and the TMA of B). The sorted [m, K] rows of the gather
//   never exist in device memory.
// - gmm_kernel's B: B_NK is rhs[g] as it lies, [N, K], K-major (wgmma's
//   natural B), one TMA box of 64 x 256 from a 3-D map over [e, N, K].
//   B_KN is [K, N], MN-major: four 64 x 64 boxes (64 reduction rows, 64
//   columns) from a 3-D map over [e, K, N], which wgmma reads with the B
//   transpose bit set (as tgmm reads dy). B_SWIGLU fills the same four
//   atoms with the tile's 128 gate columns rhs[g][:, c0 : c0 + 128] and
//   the same 128 up columns rhs[g][:, f + c0 : f + c0 + 128], from two
//   3-D maps of row pitch 2f over the gate half and the up half, so a
//   partial tile reads zeros past f and not the other half. Boxes wholly
//   past the output width are not loaded (their columns are not stored).
// - tgmm: work items are (group, K tile, N tile) output tiles, the same
//   count for every group; each contracts its group's rows in 64-row
//   slices, lhs and dy both by TMA from 2-D maps and both MN-major (the
//   output's K and N are the contiguous dims), so wgmma reads them with
//   both transpose bits set. Rows of a group's last, partial slice that
//   belong to the next group (or lie past the groups, where NaN may
//   sit) are zeroed in both operands by the consumers before the wgmma
//   that reads the stage. An empty group's tile is zeros. Each tile sums
//   all its group's rows in one block, in row order: deterministic.
// - Epilogue: swiglu first takes silu(gate) * up in float32 in
//   registers (gate column c and up column c + 128 of the m64n256
//   accumulator sit in the same thread, n-chunks j and j + 16), the
//   reference's rounding. Each consumer then rounds its 64 x 256 (swiglu:
//   64 x 128) result to bf16 and sends it out 64 columns at a time
//   through a 64 x 64 swizzled atom of shared memory, from which its
//   threads store whole 128-byte row pieces with 16-byte vectors (rows
//   below the group's end; the scatter modes to out[dst_rows[r]]) and go
//   on to the next tile without waiting for them. Stored straight from
//   the fragments (4 bytes a thread, eight 16-byte pieces a warp
//   instruction) the epilogue took a quarter of the transposed gmm's time
//   and two fifths of tgmm's.
#pragma once

#include "hopper.cuh"
#include "mma_gemm.cuh"

namespace ptt {
namespace moe90 {

constexpr int BM = 128;        // output rows (tgmm: K rows) of a tile
constexpr int BN = 256;        // output columns of a tile
constexpr int BK = 64;         // reduction depth of a stage: one atom
constexpr int THREADS = 384;
constexpr int MAX_E = 1024;    // the entry points' MAX_EXPERTS
constexpr int ATOM = 64 * 64;  // elements of a 64-row swizzle atom
constexpr int A_ELEMS = BM * BK, B_ELEMS = BN * BK;
constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
constexpr uint32_t STAGE_BYTES = STAGE_ELEMS * sizeof(bf16);
constexpr uint32_t B_BYTES = B_ELEMS * sizeof(bf16);
constexpr int STAGES = 4;
// how B = rhs[g] lies in gmm_kernel (see the note above)
constexpr int B_NK = 0, B_KN = 1, B_SWIGLU = 2;
// output columns of a gmm_kernel tile
__host__ __device__ constexpr int tile_cols(int bl) {
  return bl == B_SWIGLU ? BN / 2 : BN;
}
// stages a gather copier runs ahead of its arrival: it waits for its
// copies of stage i only after issuing stage i + LAG, and the consumers
// hold one stage while waiting for the next, so LAG <= STAGES - 2
constexpr int LAG = STAGES - 2;
// setmaxnreg budgets: a producer thread that only issues TMA needs few
// registers, the gather's copiers hold 8 row indices (40 spill); the
// consumers take the rest (128 x 24 + 256 x 240 = 128 x 56 + 256 x 224 =
// 64,512)
constexpr int REGS_TMA = 24, REGS_GATHER = 56;
template <bool GATHER>
__host__ __device__ constexpr int consumer_regs() {
  return GATHER ? 224 : 240;
}
// shared memory: slack to align the ring to 1024 bytes, the ring, the
// consumers' two epilogue atoms, the mbarriers, the schedule (group
// starts, cumulative tile counts) and the scan's partials
constexpr size_t SMEM =
    1024 + (size_t)STAGES * STAGE_BYTES + 2 * ATOM * sizeof(bf16) +
    2 * STAGES * sizeof(uint64_t) +
    sizeof(int) * (2 * (MAX_E + 1) + THREADS / 32 + 1);
static_assert(SMEM <= 232448, "a block's shared memory");

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// silu in float32 by the fast intrinsics (a few ulp, far below the bf16
// output's rounding): IEEE expf and division here cost a fifth of the
// swiglu mode at training widths (latency chains that two warps a
// scheduler cannot hide)
__device__ __forceinline__ float silu(float g) {
  return __fdividef(g, 1.f + __expf(-g));
}

// exclusive prefix sums of v(0 .. n-1) into out[0 .. n] (out[n] the
// total), n <= MAX_E, by all THREADS threads of the block
template <class F>
__device__ __forceinline__ void block_scan(int* out, int n, F v, int* part) {
  constexpr int PER = cdiv(MAX_E, THREADS);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int x[PER], s = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid * PER + j;
    x[j] = i < n ? v(i) : 0;
    s += x[j];
  }
  int inc = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      const int p = part[w];
      part[w] = acc;
      acc += p;
    }
    out[n] = acc;
  }
  __syncthreads();
  int run = part[warp] + inc - s;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid * PER + j;
    if (i < n) out[i] = run;
    run += x[j];
  }
  __syncthreads();
}

// start[g] = first row of group g, clamped to m, for g <= e (start[e]:
// the rows the groups cover)
__device__ __forceinline__ void group_starts(int* start, const int* gs,
                                             int e, int m, int* part) {
  block_scan(start, e, [&](int g) { return min(max(gs[g], 0), m); }, part);
  for (int g = threadIdx.x; g <= e; g += THREADS) start[g] = min(start[g], m);
  __syncthreads();
}

// the block's shared memory: the ring at a 1024-byte boundary, the
// consumers' epilogue atoms, STAGES "full" and STAGES "empty" mbarriers,
// then the schedule
struct Smem {
  bf16* ring;
  bf16* stage_out;   // [2][64 x 64], consumer c's at c * ATOM
  uint64_t* full;
  uint64_t* empty;
  int* start;   // [MAX_E + 1]
  int* cum;     // [MAX_E + 1]
  int* part;    // [THREADS / 32 + 1]

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    unsigned char* base =
        raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023);
    ring = reinterpret_cast<bf16*>(base);
    stage_out = ring + STAGES * STAGE_ELEMS;
    full = reinterpret_cast<uint64_t*>(stage_out + 2 * ATOM);
    empty = full + STAGES;
    start = reinterpret_cast<int*>(empty + STAGES);
    cum = start + MAX_E + 1;
    part = cum + MAX_E + 1;
  }

  // by thread 0; the block syncs (group_starts) before any use
  __device__ __forceinline__ void init(uint32_t full_count) const {
    using namespace sm90;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full + s, full_count);
        mbar_init(empty + s, 8);   // lane 0 of each consumer warp
      }
      fence_barrier_init();
    }
  }
};

// The epilogue of consumer c (128 threads): the first COLS columns of its
// 64 x BN accumulator (wgmma layout), rounded to bf16, or (acc null)
// zeros, go out 64 columns at a time through its 64 x 64 atom of shared
// memory (chunk j of row r at chunk j ^ (r % 8), so neither the fragment
// writes nor the row reads conflict), then from there as whole 128-byte
// row pieces, 16 bytes a thread: dst[k] is where row tid / 8 + 16 k of
// the consumer's 64 goes (null: not stored), from column n0 on; columns
// below N. The global
// stores are not waited for: the next tile's products run under them.
// The accumulator lives only inside the branch that ran the products, so
// no other path merges into its registers.
template <int COLS = BN>
__device__ __forceinline__ void store_tile(bf16* atom, bf16* const (&dst)[4],
                                           const float* acc, int n0, int N,
                                           int c) {
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4, q = lane % 4;
#pragma unroll
  for (int p = 0; p < COLS / 64; ++p) {
    sm90::bar_sync(2 + c, 128);   // the last pass's reads are done
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + 8 * hr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * (8 * p + j) + 2 * hr;
        *reinterpret_cast<__nv_bfloat162*>(
            atom + r * 64 + ((j ^ (r % 8)) * 8) + 2 * q) =
            acc ? __floats2bfloat162_rn(acc[e], acc[e + 1])
                : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
    sm90::bar_sync(2 + c, 128);   // the atom is written
    const int ch = tid % 8, n = n0 + 64 * p + 8 * ch;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = tid / 8 + 16 * k;
      if (dst[k] != nullptr && n < N)   // N % 8 == 0: whole chunks
        *reinterpret_cast<uint4*>(dst[k] + 64 * p + 8 * ch) =
            *reinterpret_cast<const uint4*>(atom + r * 64 +
                                            ((ch ^ (r % 8)) * 8));
    }
  }
}

// ---------------------------------------------------------------- gmm

struct Tile {
  int g;      // group, or -1 for a tile of rows no group owns
  int row0;   // first row
  int rows;   // rows of the tile that are stored
  int n0;     // first output column
};

// tile t of gmm_kernel's schedule (tiles of tn output columns): groups in
// order, inside a group column tiles in order and row tiles fastest; then
// the zero tiles
__device__ __forceinline__ Tile tile_at(int t, const int* start,
                                        const int* cum, int e, int m,
                                        int tn) {
  int g = -1, row0 = start[e], rows = m - start[e], local = t - cum[e];
  if (t < cum[e]) {   // the last group with cum[g] <= t (it has tiles)
    int lo = 0, hi = e - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (cum[mid] <= t) lo = mid; else hi = mid - 1;
    }
    g = lo;
    row0 = start[g];
    rows = start[g + 1] - start[g];
    local = t - cum[g];
  }
  const int nrt = cdiv(rows, BM), ct = local / nrt, rt = local - ct * nrt;
  row0 += rt * BM;
  return Tile{g, row0, min(BM, rows - rt * BM), ct * tn};
}

// load_b: B's boxes of reduction slice kb of the tile at output column
// n0 of group g (output width N), into the stage's B at sb on `bar`;
// b_bytes: the bytes they bring. B_KN and B_SWIGLU skip boxes wholly
// past N (TMA would fill them with zeros): the stale atoms feed only
// accumulator columns past N, which are never stored.
template <int BL>
__device__ __forceinline__ uint32_t b_bytes(int n0, int N) {
  if (BL == B_NK) return B_BYTES;
  const int boxes = min(tile_cols(BL) / 64, cdiv(N - n0, 64));
  return (BL == B_SWIGLU ? 2 : 1) * boxes * ATOM * sizeof(bf16);
}

template <int BL>
__device__ __forceinline__ void load_b(bf16* sb, const CUtensorMap* tb,
                                       const CUtensorMap* tu, uint64_t* bar,
                                       int kb, int n0, int g, int N) {
  using namespace sm90;
  if (BL == B_NK) {
    tma_load_3d(sb, tb, bar, kb * BK, n0, g);
    return;
  }
  constexpr int NA = tile_cols(BL) / 64;   // atoms of one map's columns
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    if (n0 + 64 * a < N) {
      tma_load_3d(sb + a * ATOM, tb, bar, n0 + 64 * a, kb * BK, g);
      if (BL == B_SWIGLU)   // the up half: accumulator columns 128 on
        tma_load_3d(sb + (NA + a) * ATOM, tu, bar, n0 + 64 * a, kb * BK,
                    g);
    }
  }
}

// grid: one block an SM (at most the tiles there can be), THREADS
// threads, SMEM bytes of shared memory. N is the output width (swiglu:
// f). ta: 2-D map over lhs [m, K], box (64, BM) (unused when GATHER);
// tb: 3-D map over rhs, B_NK [e, N, K] box (64, BN, 1), B_KN [e, K, N]
// box (64, 64, 1), B_SWIGLU the gate half of [e, K, 2f] box (64, 64, 1);
// tu: the up half (B_SWIGLU only)
template <bool GATHER, int BL>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tu,
               const bf16* __restrict__ x, const int* __restrict__ src,
               const int* __restrict__ gs, const int* __restrict__ dst,
               bf16* __restrict__ out, int m, int K, int N, int e) {
  using namespace sm90;
  constexpr int TN = tile_cols(BL);
  extern __shared__ unsigned char moe_raw[];
  const Smem sh(moe_raw);
  const int n_ct = cdiv(N, TN), nk = cdiv(K, BK);

  sh.init(GATHER ? 129 : 1);   // gather: 128 copiers + the TMA of B
  group_starts(sh.start, gs, e, m, sh.part);
  block_scan(sh.cum, e, [&](int g) {
    return cdiv(sh.start[g + 1] - sh.start[g], BM) * n_ct;
  }, sh.part);
  const int n_tiles = sh.cum[e] + cdiv(m - sh.start[e], BM) * n_ct;

  // warp-uniform roles, one branch each to the kernel's end, so each
  // role is compiled to its setmaxnreg budget
  const int wg = __shfl_sync(FULL_MASK, threadIdx.x / 128, 0);
  if (wg == 0) {
    // -------------------------------------------------------- producer
    regs_dealloc<GATHER ? REGS_GATHER : REGS_TMA>();
    if (GATHER) {
      // thread i copies 16-byte chunk i % 8 of rows i / 8 + 16 j
      const int tid = threadIdx.x, ch = tid % 8, r_first = tid / 8;
      int it = 0, arrived = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, sh.start, sh.cum, e, m, TN);
        if (tl.g < 0) continue;
        int srow[BM / 16];
#pragma unroll
        for (int j = 0; j < BM / 16; ++j) {
          const int r = r_first + 16 * j;
          srow[j] = r < tl.rows ? src[tl.row0 + r] : -1;
        }
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(sh.empty + s, ((it / STAGES) & 1) ^ 1);
          bf16* st = sh.ring + s * STAGE_ELEMS;
          if (tid == 0) {
            mbar_expect_tx(sh.full + s, b_bytes<BL>(tl.n0, N));
            load_b<BL>(st + A_ELEMS, &tb, &tu, sh.full + s, kb, tl.n0, tl.g,
                       N);
          }
          const int k = kb * BK + ch * 8;
#pragma unroll
          for (int j = 0; j < BM / 16; ++j) {
            const int r = r_first + 16 * j;
            const bool ok = srow[j] >= 0 && k < K;
            cp_async16(st + r * 64 + ((ch ^ (r & 7)) * 8),
                       ok ? x + (size_t)srow[j] * K + k : x, ok);
          }
          cp_async_commit();
          if (it - arrived >= LAG) {   // stage `arrived` has landed
            cp_async_wait<LAG>();
            fence_proxy_async();
            mbar_arrive(sh.full + arrived % STAGES);
            ++arrived;
          }
        }
      }
      cp_async_wait<0>();
      fence_proxy_async();
      for (; arrived < it; ++arrived)
        mbar_arrive(sh.full + arrived % STAGES);
    } else if (threadIdx.x == 0) {
      prefetch_tmap(&ta);
      prefetch_tmap(&tb);
      if (BL == B_SWIGLU) prefetch_tmap(&tu);
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, sh.start, sh.cum, e, m, TN);
        if (tl.g < 0) continue;
        const uint32_t bytes = A_ELEMS * sizeof(bf16) + b_bytes<BL>(tl.n0, N);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(sh.empty + s, ((it / STAGES) & 1) ^ 1);
          bf16* st = sh.ring + s * STAGE_ELEMS;
          mbar_expect_tx(sh.full + s, bytes);
          tma_load_2d(st, &ta, sh.full + s, kb * BK, tl.row0);
          load_b<BL>(st + A_ELEMS, &tb, &tu, sh.full + s, kb, tl.n0, tl.g, N);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    regs_alloc<consumer_regs<GATHER>()>();
    const int c = wg - 1;   // 64-row half of the tile
    bf16* atom = sh.stage_out + c * ATOM;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile tl = tile_at(t, sh.start, sh.cum, e, m, TN);
      bf16* rows[4];   // this thread's rows of the epilogue
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 64 * c + (threadIdx.x % 128) / 8 + 16 * k;
        const int row = tl.row0 + r;
        rows[k] = r < tl.rows
                      ? out + (size_t)(dst ? dst[row] : row) * N + tl.n0
                      : nullptr;
      }
      if (tl.g >= 0) {
        float acc[BN / 2];
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(sh.full + s, (it / STAGES) & 1);
          const bf16* st = sh.ring + s * STAGE_ELEMS;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da =
                desc_sw128(st + 64 * c * 64 + kk * 16, 0, 1024);
            if (BL == B_NK)
              wgmma_ss(acc, da, desc_sw128(st + A_ELEMS + kk * 16, 0, 1024),
                       kb > 0 || kk > 0);
            else   // MN-major: 16 reduction rows a step, atoms LBO apart
              wgmma_ss<0, 1>(acc, da,
                             desc_sw128(st + A_ELEMS + kk * 16 * 64,
                                        ATOM * sizeof(bf16), 1024),
                             kb > 0 || kk > 0);
          }
          wgmma_commit();
          if (kb > 0) {   // the previous slice's wgmma is done with its stage
            wgmma_wait<1>();
            warp_arrive(sh.empty + (it - 1) % STAGES);
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        warp_arrive(sh.empty + (it - 1) % STAGES);
        if (BL == B_SWIGLU) {
          // gate column 8 j + i and up column 128 + 8 j + i: acc[4 j + ..]
          // and acc[4 (j + 16) + ..], in float32, cast once at the store
#pragma unroll
          for (int i = 0; i < BN / 4; ++i)
            acc[i] = silu(acc[i]) * acc[i + BN / 4];
        }
        store_tile<TN>(atom, rows, acc, tl.n0, N, c);
      } else {   // rows no group owns
        store_tile<TN>(atom, rows, nullptr, tl.n0, N, c);
      }
    }
  }
}

// ---------------------------------------------------------------- tgmm

// grid: one block an SM (at most e x tiles a group), THREADS threads,
// SMEM bytes. tl / td: 2-D maps over lhs [m, K] and dy [m, N], box (64,
// BK)
__global__ void __launch_bounds__(THREADS, 1)
    tgmm_kernel(const __grid_constant__ CUtensorMap tl,
                const __grid_constant__ CUtensorMap td,
                const int* __restrict__ gs, bf16* __restrict__ out, int m,
                int K, int N, int e) {
  using namespace sm90;
  constexpr int NB = BN / 64;   // dy atoms of a stage
  extern __shared__ unsigned char moe_raw[];
  const Smem sh(moe_raw);
  const int n_kt = cdiv(K, BM), per = n_kt * cdiv(N, BN);
  const int n_tiles = e * per;

  sh.init(1);
  group_starts(sh.start, gs, e, m, sh.part);

  // tile t: group t / per, then N tiles, K tiles fastest
  auto decode = [&](int t, int& g, int& k0, int& n0) {
    g = t / per;
    const int local = t - g * per, nt = local / n_kt;
    k0 = (local - nt * n_kt) * BM;
    n0 = nt * BN;
  };
  const int wg = __shfl_sync(FULL_MASK, threadIdx.x / 128, 0);
  if (wg == 0) {
    // -------------------------------------------------------- producer
    regs_dealloc<REGS_TMA>();
    if (threadIdx.x == 0) {
      prefetch_tmap(&tl);
      prefetch_tmap(&td);
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int g, k0, n0;
        decode(t, g, k0, n0);
        const int ns = cdiv(sh.start[g + 1] - sh.start[g], BK);
        for (int sl = 0; sl < ns; ++sl, ++it) {
          const int s = it % STAGES, r0 = sh.start[g] + sl * BK;
          mbar_wait(sh.empty + s, ((it / STAGES) & 1) ^ 1);
          bf16* st = sh.ring + s * STAGE_ELEMS;
          mbar_expect_tx(sh.full + s, STAGE_BYTES);
#pragma unroll
          for (int a = 0; a < BM / 64; ++a)
            tma_load_2d(st + a * ATOM, &tl, sh.full + s, k0 + 64 * a, r0);
#pragma unroll
          for (int a = 0; a < NB; ++a)
            tma_load_2d(st + A_ELEMS + a * ATOM, &td, sh.full + s,
                        n0 + 64 * a, r0);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    regs_alloc<consumer_regs<false>()>();
    const int c = wg - 1;   // 64 K rows of the tile: lhs atom c
    const int tid = threadIdx.x - 128 * wg;
    bf16* atom = sh.stage_out + c * ATOM;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int g, k0, n0;
      decode(t, g, k0, n0);
      const int rows = sh.start[g + 1] - sh.start[g], ns = cdiv(rows, BK);
      bf16* rows_out[4];   // this thread's rows of the epilogue
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + 64 * c + tid / 8 + 16 * q;
        rows_out[q] = k < K ? out + ((size_t)g * K + k) * N + n0 : nullptr;
      }
      if (ns > 0) {
        float acc[BN / 2];
        for (int sl = 0; sl < ns; ++sl, ++it) {
          const int s = it % STAGES;
          mbar_wait(sh.full + s, (it / STAGES) & 1);
          bf16* st = sh.ring + s * STAGE_ELEMS;
          const int valid = rows - sl * BK;
          if (valid < BK) {
            // rows past the group: zero them in this consumer's lhs atom
            // and its half of dy's atoms, then hand the generic writes to
            // the async proxy before either consumer's wgmma reads them
            const uint4 z = make_uint4(0, 0, 0, 0);
            for (int i = valid * 8 + tid; i < BK * 8; i += 128) {
              *reinterpret_cast<uint4*>(st + c * ATOM + i * 8) = z;
#pragma unroll
              for (int a = 0; a < NB / 2; ++a)
                *reinterpret_cast<uint4*>(
                    st + A_ELEMS + (c * NB / 2 + a) * ATOM + i * 8) = z;
            }
            fence_proxy_async();
            bar_sync(1, 256);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_ss<1, 1>(acc,
                           desc_sw128(st + c * ATOM + kk * 16 * 64,
                                      ATOM * sizeof(bf16), 1024),
                           desc_sw128(st + A_ELEMS + kk * 16 * 64,
                                      ATOM * sizeof(bf16), 1024),
                           sl > 0 || kk > 0);
          wgmma_commit();
          if (sl > 0) {
            wgmma_wait<1>();
            warp_arrive(sh.empty + (it - 1) % STAGES);
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        warp_arrive(sh.empty + (it - 1) % STAGES);
        store_tile(atom, rows_out, acc, n0, N, c);
      } else {   // an empty group's slice is zeros
        store_tile(atom, rows_out, nullptr, n0, N, c);
      }
    }
  }
}

// ---------------------------------------------------------------- launch

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return n;
}

// gmm_kernel with B laid out as `bl`: x [m, K] (or, gathered, [s, K]
// read at src_rows), rhs [e, N, K] (B_NK), [e, K, N] (B_KN) or [e, K, 2N]
// (B_SWIGLU), out [m, N] (or at dst_rows)
inline cudaError_t launch_gmm(int bl, const void* x, const int* src,
                              const void* rhs, const int* gs, const int* dst,
                              void* out, int m, int K, int N, int e,
                              cudaStream_t stream) {
  CUtensorMap ta{}, tb{}, tu{};
  cudaError_t err;
  if (bl == B_NK)
    err = sm90::tmap_3d(&tb, rhs, e, N, K, BN);
  else if (bl == B_KN)
    err = sm90::tmap_3d(&tb, rhs, e, K, N, 64);
  else {
    err = sm90::tmap_3d(&tb, rhs, e, K, N, 64, 2 * N);
    if (err == cudaSuccess)
      err = sm90::tmap_3d(&tu, static_cast<const bf16*>(rhs) + N, e, K, N,
                          64, 2 * N);
  }
  if (err == cudaSuccess && src == nullptr)
    err = sm90::tmap_2d(&ta, x, m, K, BM);
  if (err != cudaSuccess) return err;
  using Kernel = decltype(&gmm_kernel<false, B_NK>);
  const Kernel kernels[2][3] = {
      {gmm_kernel<false, B_NK>, gmm_kernel<false, B_KN>,
       gmm_kernel<false, B_SWIGLU>},
      {gmm_kernel<true, B_NK>, gmm_kernel<true, B_KN>,
       gmm_kernel<true, B_SWIGLU>}};
  const Kernel kernel = kernels[src != nullptr][bl];
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (err != cudaSuccess) return err;
  // at most one partial row tile a group beyond m / BM, and the zero tiles
  const long bound = (long)(cdiv(m, BM) + e + 1) * cdiv(N, tile_cols(bl));
  const int grid = (int)(bound < sm_count() ? bound : sm_count());
  kernel<<<grid, THREADS, SMEM, stream>>>(ta, tb, tu, (const bf16*)x, src, gs,
                                          dst, (bf16*)out, m, K, N, e);
  return cudaGetLastError();
}

// lhs [m, K], dy [m, N] sorted rows -> out [e, K, N]
inline cudaError_t launch_tgmm(const void* lhs, const void* dy,
                               const int* gs, void* out, int m, int K,
                               int N, int e, cudaStream_t stream) {
  CUtensorMap tl, td;
  cudaError_t err = sm90::tmap_2d(&tl, lhs, m, K, BK);
  if (err == cudaSuccess) err = sm90::tmap_2d(&td, dy, m, N, BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tgmm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (err != cudaSuccess) return err;
  const long tiles = (long)e * cdiv(K, BM) * cdiv(N, BN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  tgmm_kernel<<<grid, THREADS, SMEM, stream>>>(tl, td, gs, (bf16*)out, m, K,
                                              N, e);
  return cudaGetLastError();
}

}  // namespace moe90
}  // namespace ptt
