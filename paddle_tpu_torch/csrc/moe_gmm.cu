// K4 and K5: a grouped matmul over expert-sorted rows,
// out[r] = lhs[r] @ rhs[group(r)], where the rows of group g are
// [offsets[g], offsets[g + 1]) and offsets is the exclusive cumsum of
// group_sizes [e]; and its weight gradient tgmm. Entry points:
//
// - ptt_moe_gather_gmm_swiglu: the lhs rows are gathered on read,
//   lhs[r] = x[src_rows[r]] (the MoE dispatch's sort), and the epilogue
//   is swiglu over the two halves of rhs [e, d, 2f]:
//   out[r] = silu(lhs[r] @ rhs[g][:, :f]) * (lhs[r] @ rhs[g][:, f:]);
// - ptt_moe_scatter_gmm: the store is scattered, out[dst_rows[r]] = row r
//   (the combine's unsort; dst_rows is a permutation, so no atomics);
// - ptt_moe_gmm: neither (K5's megablox gmm on sorted rows), or the plain
//   gather when src_rows is given;
// - ptt_moe_gmm_t: the transposed modes of the backward, rhs [e, N, K]
//   contracted over its last dim, out[r] = lhs[r] @ rhs[g]^T, with the
//   gather on read (src_rows), the scatter on write (dst_rows) or
//   neither (K5's d(lhs));
// - ptt_moe_tgmm: out[g] = lhs[rows of g]^T @ dy[rows of g], [e, K, N]
//   (K5's tgmm, the weight gradient of both expert matmuls); an empty
//   group's slice is zeros.
//
// Replaces: paddle_tpu/ops/pallas/moe_gmm.py, `kernel` of
// _call_grouped_32 (via gather_gmm_swiglu, scatter_gmm and gather_gmm,
// with and without transpose_rhs), and the stock megablox gmm, its
// transpose_rhs d(lhs) and tgmm called from paddle_tpu/distributed/moe.py
// (_gmm32, _mb_bwd_dlhs, _mb_bwd_drhs).
//
// What bounds it on the H100: bytes at serving widths, operations at
// training widths. An MoE layer at serving widths gives each expert a
// few rows (a decode tick of 8 tokens x top-6 is 48 rows over 64
// experts), so every touched expert's weights are streamed for ~1-30
// rows: far below the ~295 flops per byte that would make the tensor
// cores the limit. A training step of 2 x 4096 tokens gives each expert
// ~768 rows, and there the products bound it.
//
// What runs where (bf16): every mode at training widths, and the
// backward's modes (transposed gmm, tgmm) at any width, run the
// persistent warp-specialised Hopper kernels of moe_gmm_sm90.cuh (wgmma
// m64n256k16 fed by TMA, a device-side tile schedule, a swizzled
// epilogue; see there). The forward modes (gather + swiglu, scatter,
// gmm) take that body when the mean rows a group, ceil(m / e), is at
// least SM90_MIN_ROWS, and below it the mma.sync body here, which does
// the same arithmetic: two hand-written kernels chosen by shape.
//
// The mma.sync body (forward modes at few rows a group): the TPU kernel
// walks a CSR list of (group, row tile) visits and revisits a row tile
// once for every group starting inside it. Here one thread block takes
// one (column tile, expert): it computes its expert's row range from
// group_sizes itself (a block-wide sum of the sizes before it, so no
// host round trip and no second kernel), returns at once for an empty
// group, and loops over the group's rows in chunks of BM = 16, 32 or 64
// (picked from the mean group size). A chunk's row indices (source and
// destination) are staged in shared memory first; the lhs rows then
// arrive with 16-byte cp.async copies straight from x[src_rows[r]] (so
// the sorted [m, d] buffer never exists in device memory) and the
// expert's weight slice with 16-byte cp.async copies, both through a
// 3-stage ring of 64-deep K slices; bfloat16 contracts on the tensor
// cores (mma.sync m16n8k16, float32 accumulation; fragments and warp
// layout from mma_gemm.cuh). An expert's weight tile is read again for
// each chunk of its rows; the L2 cache serves those repeats. At serving
// widths (a few rows an expert) these modes stream their weights at
// 1.2-1.5x the bytes bound; at training widths they ran at 6-7x the
// operations bound, which is why the Hopper body takes over there. The
// swiglu tile is 64 gate columns beside the same 64 up columns of rhs,
// so one pass feeds both accumulators; the epilogue stages the float32
// tile in shared memory and writes silu(gate) * up, cast once. The
// scatter epilogue writes row r of the chunk to dst_rows[r]. Rows past
// the last group's end are written as zeros by the last expert's
// blocks.
//
// float32 takes one of three bodies on the CUDA cores, all with full
// float32 products (the float32 gradient and LoRA checks keep them), by a
// shape rule on the mode, K and N alone (f32_body; ptt_moe_gmm_f32_body
// reports it):
// - the gather or plain gmm at N <= 64 (the multi-LoRA delta's A side,
//   ops/lora.py, N the adapter rank padded to 8): moe_gmm_split_k of
//   moe_gmm_lora.cuh, K split in 8 slices over a thread-block cluster,
//   the slices' partials summed in rank order through distributed shared
//   memory;
// - the scatter gmm at K <= 64 (the delta's B side, K that rank):
//   moe_gmm_wide_scatter of moe_gmm_lora.cuh, one block a (16-row tile,
//   512 columns);
// - everything else (swiglu, the transposed modes, wider ranks, the MoE
//   widths): moe_gmm_fma, the FMA tile of tile_gemm.cuh (two passes for
//   swiglu), and a 64 x 64 FMA tile for tgmm.
// Each sums a row's products in an order fixed by K and N, whatever
// the chunking or the rows beside it, so a row's LoRA delta does not
// depend on the rows batched with it, and two launches agree to the bit.
// The rule never reads m or the group sizes, so a row alone and in a
// batch take the same body.
//
// Shapes: x [s, K] (gathered) or [m, K]; src_rows / dst_rows [m] int32;
// rhs [e, K, N] row-major ([e, N, K] transposed); group_sizes [e] int32,
// each >= 0, summing to at most m (row ranges are clamped to m); out
// [m, N] (scatter: indexed by dst_rows) or [m, N / 2] for swiglu; tgmm:
// lhs [m, K], dy [m, N], out [e, K, N]. float32 or bfloat16 throughout;
// K and N multiples of 8 (N / 2 for swiglu), 16-byte aligned pointers;
// 1 <= e <= MAX_EXPERTS; any m >= 1.
#include "mma_gemm.cuh"
#include "moe_gmm_lora.cuh"
#include "moe_gmm_sm90.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace ptt;

constexpr int MAX_EXPERTS = moe90::MAX_E;
// mean rows a group, ceil(m / e), from which the bf16 forward modes run
// the Hopper body of moe_gmm_sm90.cuh: it was faster at every size swept
// (9-768 rows a group, PERF.md), and the serving ticks (13 and 17 rows a
// group at the prefill tick) keep the mma.sync body. A build may set it
// to time the two bodies against each other (tools/flash_variants.py
// --sweep).
#ifndef PTT_MOE_SM90_MIN_ROWS
#define PTT_MOE_SM90_MIN_ROWS 24
#endif
constexpr int SM90_MIN_ROWS = PTT_MOE_SM90_MIN_ROWS;
constexpr int SWIGLU_HALF = MMA_BN / 2;  // gate (and up) columns a tile

struct GroupArgs {
  const void* x;
  const int* src;   // gather indices [m] or null
  const void* w;    // [e, K, N], or [e, N, K] transposed
  const int* gs;    // [e]
  const int* dst;   // scatter indices [m] or null
  void* out;
  int m, K, N, nout, e;
};

// rows [start, end) of group g, clamped to m: every thread of the block
// calls it
template <int THREADS>
__device__ __forceinline__ int2 group_rows(const int* __restrict__ gs,
                                           int g, int m) {
  __shared__ int part[THREADS / 32];
  __shared__ int2 res;
  int s = 0;
  for (int i = threadIdx.x; i < g; i += THREADS) s += max(gs[i], 0);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(FULL_MASK, s, off);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int start = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) start += part[w];
    start = min(start, m);
    res = make_int2(start, min(start + max(gs[g], 0), m));
  }
  __syncthreads();
  return res;
}

__device__ __forceinline__ float silu_f(float g) {
  return g / (1.f + expf(-g));
}

// ---------------------------------------------------------------- bf16

template <int BM>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(bf16) * MMA_STAGES * (BM * MMA_LDA + MMA_BK * MMA_LDB);
}

template <int BM>
constexpr size_t mma_smem() {
  return ring_bytes<BM>() + 2 * BM * sizeof(int);
}

// grid (column tiles, experts), MMA_THREADS threads; SWIGLU tiles cover
// SWIGLU_HALF output columns (gate and up), the others MMA_BN
template <int BM, bool SWIGLU>
__global__ void __launch_bounds__(MMA_THREADS) moe_gmm_mma(GroupArgs a) {
  using WT = WarpTile<BM>;
  const int g = blockIdx.y;
  const int2 rows = group_rows<MMA_THREADS>(a.gs, g, a.m);
  const bool last = g == a.e - 1 && rows.y < a.m;
  if (rows.x >= rows.y && !last) return;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*As)[BM][MMA_LDA] = reinterpret_cast<bf16(*)[BM][MMA_LDA]>(smem);
  bf16* b_ring = reinterpret_cast<bf16*>(
      smem + sizeof(bf16) * MMA_STAGES * BM * MMA_LDA);
  int* src_s = reinterpret_cast<int*>(smem + ring_bytes<BM>());
  int* dst_s = src_s + BM;
  float(*Cs)[MMA_BN + 4] = reinterpret_cast<float(*)[MMA_BN + 4]>(smem);

  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w =
      static_cast<const bf16*>(a.w) + (size_t)g * a.K * a.N;
  bf16* out = static_cast<bf16*>(a.out);
  const int K = a.K, N = a.N, nout = a.nout;
  const int col0 = blockIdx.x * (SWIGLU ? SWIGLU_HALF : MMA_BN);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WT::WARPS_N, wn = warp % WT::WARPS_N;
  const int mi = lane / 8, ri = lane % 8;
  const int nk = (K + MMA_BK - 1) / MMA_BK;

  for (int r0 = rows.x; r0 < rows.y; r0 += BM) {
    const int nr = min(BM, rows.y - r0);
    __syncthreads();  // the previous chunk is done with shared memory
    for (int i = tid; i < BM; i += MMA_THREADS) {
      src_s[i] = i < nr ? (a.src ? a.src[r0 + i] : r0 + i) : -1;
      dst_s[i] = i < nr ? (a.dst ? a.dst[r0 + i] : r0 + i) : -1;
    }
    __syncthreads();

    auto issue = [&](int slice) {
      const int k0 = slice * MMA_BK, st = slice % MMA_STAGES;
      for (int i = tid; i < BM * (MMA_BK / 8); i += MMA_THREADS) {
        const int mm = i / (MMA_BK / 8), kk = (i % (MMA_BK / 8)) * 8;
        const int sr = src_s[mm];
        const bool ok = sr >= 0 && k0 + kk < K;
        cp_async16(&As[st][mm][kk], ok ? x + (size_t)sr * K + k0 + kk : x,
                   ok);
      }
      bf16* bst = b_ring + st * MMA_BK * MMA_LDB;   // [k][n] of rhs
      for (int i = tid; i < MMA_BK * (MMA_BN / 8); i += MMA_THREADS) {
        const int kk = i / (MMA_BN / 8), c = (i % (MMA_BN / 8)) * 8;
        int wc;
        bool ok;
        if (SWIGLU) {
          const bool up = c >= SWIGLU_HALF;
          const int cc = col0 + (up ? c - SWIGLU_HALF : c);
          ok = cc < nout;
          wc = up ? nout + cc : cc;
        } else {
          wc = col0 + c;
          ok = wc < N;
        }
        ok = ok && k0 + kk < K;
        cp_async16(bst + kk * MMA_LDB + c,
                   ok ? w + (size_t)(k0 + kk) * N + wc : w, ok);
      }
    };

    float acc[WT::MT][WT::NT][4];
#pragma unroll
    for (int mt = 0; mt < WT::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < WT::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
    for (int s = 0; s < MMA_STAGES - 1; ++s) {
      if (s < nk) issue(s);
      cp_async_commit();
    }
    for (int it = 0; it < nk; ++it) {
      cp_async_wait<MMA_STAGES - 2>();  // slice it has landed
      __syncthreads();                  // ... for every thread; slice it-1
                                        // is consumed by every warp
      if (it + MMA_STAGES - 1 < nk) issue(it + MMA_STAGES - 1);
      cp_async_commit();
      bf16(*as)[MMA_LDA] = As[it % MMA_STAGES];
      const bf16* bst = b_ring + (it % MMA_STAGES) * MMA_BK * MMA_LDB;
#pragma unroll
      for (int ks = 0; ks < MMA_BK; ks += 16) {
        uint32_t af[WT::MT][4], bfr[WT::NT][2];
#pragma unroll
        for (int mt = 0; mt < WT::MT; ++mt)
          ldmatrix_x4(af[mt], &as[wm * WT::WM + mt * 16 + (mi & 1) * 8 + ri]
                                 [ks + (mi >> 1) * 8]);
#pragma unroll
        for (int np = 0; np < WT::NT / 2; ++np) {
          uint32_t bq[4];
          // matrices (k0-7, n0), (k8-15, n0), (k0-7, n0+8), (k8-15, n0+8)
          ldmatrix_x4_trans(bq, bst + (ks + (mi & 1) * 8 + ri) * MMA_LDB +
                                    wn * WT::WN + np * 16 + (mi >> 1) * 8);
          bfr[2 * np][0] = bq[0];
          bfr[2 * np][1] = bq[1];
          bfr[2 * np + 1][0] = bq[2];
          bfr[2 * np + 1][1] = bq[3];
        }
#pragma unroll
        for (int mt = 0; mt < WT::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < WT::NT; ++nt)
            mma_16816(acc[mt][nt], af[mt], bfr[nt]);
      }
    }
    cp_async_wait<0>();

    if (SWIGLU) {
      __syncthreads();  // every warp is done reading the ring
#pragma unroll
      for (int mt = 0; mt < WT::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < WT::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int r, c;
            mma_store_index<BM>(mt, nt, e, r, c);
            Cs[r][c] = acc[mt][nt][e];
          }
      __syncthreads();
      for (int i = tid; i < nr * SWIGLU_HALF; i += MMA_THREADS) {
        const int r = i / SWIGLU_HALF, c = i % SWIGLU_HALF;
        const int col = col0 + c;
        if (col < nout)
          out[(size_t)dst_s[r] * nout + col] =
              __float2bfloat16(silu_f(Cs[r][c]) * Cs[r][SWIGLU_HALF + c]);
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < WT::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < WT::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            int r, c;
            mma_store_index<BM>(mt, nt, e, r, c);
            const int col = col0 + c;  // even; N % 8 == 0 keeps col + 1
            if (r < nr && col < N)
              *reinterpret_cast<__nv_bfloat162*>(
                  out + (size_t)dst_s[r] * N + col) =
                  __floats2bfloat162_rn(acc[mt][nt][e], acc[mt][nt][e + 1]);
          }
    }
  }

  if (last) {  // rows no group owns
    const int width = SWIGLU ? SWIGLU_HALF : MMA_BN;
    for (int i = tid; i < (a.m - rows.y) * width; i += MMA_THREADS) {
      const int r = rows.y + i / width, col = col0 + i % width;
      if (col < nout)
        out[(size_t)(a.dst ? a.dst[r] : r) * nout + col] =
            __float2bfloat16(0.f);
    }
  }
}

// ---------------------------------------------------------------- f32

struct GatherLoad {
  const float* x;
  const int* src;
  int K;
  __device__ __forceinline__ float operator()(int r, int k, int) const {
    return x[(size_t)(src ? src[r] : r) * K + k];
  }
};

// grid (GEMM_BN-column tiles of the output, experts), GEMM_THREADS
template <int BM, bool SWIGLU, bool TRANS>
__global__ void __launch_bounds__(GEMM_THREADS) moe_gmm_fma(GroupArgs a) {
  constexpr int TM = BM / 16;
  const int g = blockIdx.y;
  const int2 rows = group_rows<GEMM_THREADS>(a.gs, g, a.m);
  const bool last = g == a.e - 1 && rows.y < a.m;
  if (rows.x >= rows.y && !last) return;
  const float* w = static_cast<const float*>(a.w) + (size_t)g * a.K * a.N;
  float* out = static_cast<float*>(a.out);
  const int col0 = blockIdx.x * GEMM_BN, nout = a.nout;
  const GatherLoad load{static_cast<const float*>(a.x), a.src, a.K};
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  for (int r0 = rows.x; r0 < rows.y; r0 += BM) {
    float acc[TM][4], up[TM][4];
    gemm_tile<float, BM, TRANS>(load, w, rows.y, a.K, a.N, r0, col0, acc);
    if (SWIGLU)
      gemm_tile<float, BM>(load, w, rows.y, a.K, a.N, r0, nout + col0, up);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + ty + 16 * i;
      if (r >= rows.y) continue;
      const size_t o = (size_t)(a.dst ? a.dst[r] : r) * nout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx * 4 + j;
        if (col < nout)
          out[o + col] = SWIGLU ? silu_f(acc[i][j]) * up[i][j] : acc[i][j];
      }
    }
  }

  if (last) {
    for (int i = threadIdx.x; i < (a.m - rows.y) * GEMM_BN;
         i += GEMM_THREADS) {
      const int r = rows.y + i / GEMM_BN, col = col0 + i % GEMM_BN;
      if (col < nout) out[(size_t)(a.dst ? a.dst[r] : r) * nout + col] = 0.f;
    }
  }
}

// ---------------------------------------------------------------- tgmm

struct TgmmArgs {
  const void* lhs;  // [m, K]
  const void* dy;   // [m, N]
  const int* gs;    // [e]
  void* out;        // [e, K, N]
  int m, K, N, e;
};

constexpr int TGF_T = 64;   // float32 tile: 64 k x 64 n
constexpr int TGF_RS = 16;

// grid (N tiles, K tiles, experts) of TGF_T, GEMM_THREADS threads each
// owning 4 x 4 outputs
__global__ void __launch_bounds__(GEMM_THREADS) moe_tgmm_fma(TgmmArgs a) {
  const int g = blockIdx.z;
  const int2 rows = group_rows<GEMM_THREADS>(a.gs, g, a.m);
  const int K = a.K, N = a.N;
  const int k0 = blockIdx.y * TGF_T, n0 = blockIdx.x * TGF_T;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  __shared__ float As[TGF_RS][TGF_T + 4];
  __shared__ float Bs[TGF_RS][TGF_T + 4];
  const float* lhs = static_cast<const float*>(a.lhs);
  const float* dy = static_cast<const float*>(a.dy);
  float acc[4][4] = {};
  for (int r0 = rows.x; r0 < rows.y; r0 += TGF_RS) {
    for (int i = threadIdx.x; i < TGF_RS * TGF_T; i += GEMM_THREADS) {
      const int rr = i / TGF_T, c = i % TGF_T, r = r0 + rr;
      As[rr][c] = (r < rows.y && k0 + c < K) ? lhs[(size_t)r * K + k0 + c]
                                             : 0.f;
      Bs[rr][c] = (r < rows.y && n0 + c < N) ? dy[(size_t)r * N + n0 + c]
                                             : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < TGF_RS; ++rr) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = static_cast<float*>(a.out) + (size_t)g * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (k < K && n < N) out[(size_t)k * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- launch

int tiles(int n, int t) { return (n + t - 1) / t; }

// rows a block takes at once: about the mean group size
int chunk_rows(int m, int e) {
  const int mean = (m + e - 1) / e;
  return mean <= 16 ? 16 : (mean <= 32 ? 32 : 64);
}

template <int BM, bool SWIGLU>
cudaError_t launch_mma(const GroupArgs& a, cudaStream_t st) {
  const dim3 grid(tiles(a.nout, SWIGLU ? SWIGLU_HALF : MMA_BN), a.e);
  constexpr size_t smem = mma_smem<BM>();
  static_assert(BM * (MMA_BN + 4) * sizeof(float) <= ring_bytes<BM>(),
                "the swiglu epilogue tile must fit in the ring");
  cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_mma<BM, SWIGLU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  moe_gmm_mma<BM, SWIGLU><<<grid, MMA_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int BM, bool SWIGLU, bool TRANS>
cudaError_t launch_fma(const GroupArgs& a, cudaStream_t st) {
  const dim3 grid(tiles(a.nout, GEMM_BN), a.e);
  moe_gmm_fma<BM, SWIGLU, TRANS><<<grid, GEMM_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// the float32 bodies, as ptt_moe_gmm_f32_body reports them
enum F32Body { F32_FMA = 0, F32_SPLIT_K = 1, F32_WIDE_SCATTER = 2 };

// the float32 body of a call: a shape rule on the mode (swiglu, the
// transposed modes, the scatter, the gather or plain gmm) and K, N alone
int f32_body(bool swiglu, bool trans, bool scatter, int K, int N) {
  if (swiglu || trans) return F32_FMA;
  if (!scatter && N <= moe_lora::SPLIT_K_MAX_N) return F32_SPLIT_K;
  if (scatter && K <= moe_lora::WIDE_MAX_K) return F32_WIDE_SCATTER;
  return F32_FMA;
}

template <bool SWIGLU, bool TRANS>
int run(const GroupArgs& a, int dtype, void* stream) {
  if (a.m < 1 || a.K < 1 || a.N < 1 || a.e < 1 || a.e > MAX_EXPERTS ||
      a.K % 8 || a.N % 8 || a.nout % 8 || a.x == nullptr ||
      a.w == nullptr || a.gs == nullptr || a.out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int bm = chunk_rows(a.m, a.e);
  if (dtype == 0) {
    const moe_lora::Args la{static_cast<const float*>(a.x), a.src,
                            static_cast<const float*>(a.w), a.gs, a.dst,
                            static_cast<float*>(a.out), a.m, a.K, a.N, a.e};
    switch (f32_body(SWIGLU, TRANS, a.dst != nullptr, a.K, a.nout)) {
      case F32_SPLIT_K: return (int)moe_lora::launch_split_k(la, st);
      case F32_WIDE_SCATTER: return (int)moe_lora::launch_wide_scatter(la, st);
      default: break;
    }
    if (bm == 16) return (int)launch_fma<16, SWIGLU, TRANS>(a, st);
    if (bm == 32) return (int)launch_fma<32, SWIGLU, TRANS>(a, st);
    return (int)launch_fma<64, SWIGLU, TRANS>(a, st);
  }
  if (dtype == 1) {
    if (TRANS || (a.m + a.e - 1) / a.e >= SM90_MIN_ROWS) {
      const int bl = TRANS ? moe90::B_NK
                           : (SWIGLU ? moe90::B_SWIGLU : moe90::B_KN);
      return (int)moe90::launch_gmm(bl, a.x, a.src, a.w, a.gs, a.dst, a.out,
                                    a.m, a.K, a.nout, a.e, st);
    }
    if (bm == 16) return (int)launch_mma<16, SWIGLU>(a, st);
    if (bm == 32) return (int)launch_mma<32, SWIGLU>(a, st);
    return (int)launch_mma<64, SWIGLU>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// the mean rows a group from which the bf16 forward modes run the Hopper
// body
extern "C" int ptt_moe_gmm_sm90_min_rows() { return SM90_MIN_ROWS; }

// the float32 body a call takes (0 moe_gmm_fma, 1 moe_gmm_split_k, 2
// moe_gmm_wide_scatter) for mode 0 (ptt_moe_gmm, sorted or gathered rows),
// 1 (ptt_moe_gather_gmm_swiglu, N = 2f), 2 (ptt_moe_scatter_gmm) or 3
// (ptt_moe_gmm_t); m and e do not enter the rule
extern "C" int ptt_moe_gmm_f32_body(int /*m*/, int K, int N, int /*e*/,
                                    int mode) {
  if (mode < 0 || mode > 3) return -1;
  return f32_body(mode == 1, mode == 3, mode == 2, K, N);
}

// K5's forward gmm (src_rows null) or the plain gather gmm: x [m or s, K],
// rhs [e, K, N], out [m, N]
extern "C" int ptt_moe_gmm(const void* x, const void* src_rows,
                           const void* rhs, const void* group_sizes,
                           void* out, int m, int K, int N, int e, int dtype,
                           void* stream) {
  const GroupArgs a{x, (const int*)src_rows, rhs, (const int*)group_sizes,
                    nullptr, out, m, K, N, N, e};
  return run<false, false>(a, dtype, stream);
}

// gather-on-read + swiglu epilogue: rhs [e, K, 2f], out [m, f]
extern "C" int ptt_moe_gather_gmm_swiglu(const void* x, const void* src_rows,
                                         const void* rhs,
                                         const void* group_sizes, void* out,
                                         int m, int K, int f, int e,
                                         int dtype, void* stream) {
  const GroupArgs a{x, (const int*)src_rows, rhs, (const int*)group_sizes,
                    nullptr, out, m, K, 2 * f, f, e};
  return run<true, false>(a, dtype, stream);
}

// scatter-on-write: x [m, K] sorted rows, rhs [e, K, N], out[dst_rows[r]]
extern "C" int ptt_moe_scatter_gmm(const void* x, const void* rhs,
                                   const void* group_sizes,
                                   const void* dst_rows, void* out, int m,
                                   int K, int N, int e, int dtype,
                                   void* stream) {
  if (dst_rows == nullptr) return (int)cudaErrorInvalidValue;
  const GroupArgs a{x, nullptr, rhs, (const int*)group_sizes,
                    (const int*)dst_rows, out, m, K, N, N, e};
  return run<false, false>(a, dtype, stream);
}

// the transposed modes: rhs [e, N, K], out[r] (or out[dst_rows[r]]) =
// x[src_rows[r] or r] @ rhs[g]^T; src_rows and dst_rows may be null
extern "C" int ptt_moe_gmm_t(const void* x, const void* src_rows,
                             const void* rhs, const void* group_sizes,
                             const void* dst_rows, void* out, int m, int K,
                             int N, int e, int dtype, void* stream) {
  const GroupArgs a{x, (const int*)src_rows, rhs, (const int*)group_sizes,
                    (const int*)dst_rows, out, m, K, N, N, e};
  return run<false, true>(a, dtype, stream);
}

// tgmm: lhs [m, K], dy [m, N] sorted rows -> out [e, K, N], out[g] =
// lhs[rows of g]^T @ dy[rows of g] (zeros for an empty group)
extern "C" int ptt_moe_tgmm(const void* lhs, const void* dy,
                            const void* group_sizes, void* out, int m, int K,
                            int N, int e, int dtype, void* stream) {
  if (m < 1 || K < 1 || N < 1 || e < 1 || e > MAX_EXPERTS || K % 8 ||
      N % 8 || lhs == nullptr || dy == nullptr || group_sizes == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  const TgmmArgs a{lhs, dy, (const int*)group_sizes, out, m, K, N, e};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid(tiles(N, TGF_T), tiles(K, TGF_T), e);
    moe_tgmm_fma<<<grid, GEMM_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (dtype == 1)
    return (int)moe90::launch_tgmm(lhs, dy, (const int*)group_sizes, out, m,
                                   K, N, e, st);
  return (int)cudaErrorInvalidValue;
}
