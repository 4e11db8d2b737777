// K4's float32 gather and scatter modes at LoRA shapes, for Hopper: the
// two bodies moe_gmm.cu runs for a float32 call whose output is narrow
// (the gather gmm at N <= SPLIT_K_MAX_N: the delta's A side, x @ A with N
// the adapter rank padded to 8) or whose reduction is shallow (the
// scatter gmm at K <= WIDE_MAX_K: the B side, ax @ B back to the rows'
// order). Every other float32 call keeps moe_gmm_fma.
//
// What bounds them on the H100: bytes. A 136-row tick of d 4096 at rank
// 16 does 17.8 MFLOP against 3.55 MB of rows and weights, so neither
// needs the tensor cores; they need the work spread over the card. The
// FMA body ran one block a (64-column tile, group): at N 16 the whole A
// side of a tick ran on as many SMs as there were groups, each block
// walking K 16 floats at a time behind two barriers (1.2564 ms against a
// 0.0011 bound; PERF.md, NVIDIA H100 80GB HBM3, 700.00 W).
//
// moe_gmm_split_k (A side; grid (row tiles, SPLIT), clusters (1, SPLIT)):
// - Row tiles of at most TILE rows of one group are scheduled on the
//   device: every block scans group_sizes into each group's first row
//   and tile count (find_tile) and takes tile blockIdx.x; tiles past the
//   groups' cover the rows no group owns ([sum, m): zeros), and the
//   grid's surplus clusters leave. The grid, ceil(m / TILE) + e tiles,
//   comes from host ints, so nothing is read back and a CUDA graph holds
//   the launch.
// - Each tile is taken by a thread-block cluster of SPLIT blocks; block s
//   reduces K slice s, [s W, (s + 1) W) with W = ceil(K / SPLIT) rounded
//   up to 4 floats (the last slices may be short or empty).
// - A block stages its slice through a ring of KC-deep chunks with 16-byte
//   cp.async: the tile's row indices first, then each row's chunk
//   straight from x[src_rows[r]] (the sorted rows never exist in device
//   memory) and the group's A rows [KC, N], which are contiguous. The
//   ring holds STAGES chunks and all of them are in flight at once (a
//   d-4096 slice is 4 chunks of 128).
// - Products are full float32 fused multiply-adds on the CUDA cores: a
//   thread owns one row and 4 columns of the tile and a fixed share of
//   each chunk's k (every KS-th group of 4), summed in increasing k.
// - The KS shares are added in order in shared memory, then, after
//   cluster.sync(), each block sums its share of the tile's outputs over
//   the SPLIT blocks' partials, read through distributed shared memory in
//   rank order 0 .. SPLIT - 1, and stores them. No workspace, no flags, no
//   atomics and no second launch.
//
// moe_gmm_wide_scatter (B side; grid (row tiles, SPAN-column spans)):
// one block takes one row tile of one group (the same device schedule)
// and SPAN output columns: it stages the tile's [TILE, K] rows and
// B[g][:, span] ([K, SPAN], 32 KB at K 16) once with 16-byte cp.async,
// and each thread sums, in increasing k, a float4 of columns for 8 rows,
// then stores 16-byte vectors to row dst_rows[r] of the output. Rows no
// group owns are written as zeros.
//
// Which body a float32 call takes is a shape rule on the mode, K and N
// alone (f32_body in moe_gmm.cu; ptt_moe_gmm_f32_body reports it), never
// on m, the group sizes or the card, and so is every split: K's slices
// depend on K, the KS shares on N. A row's output is therefore the same
// sum in the same order whatever rows share its launch, so a row's LoRA
// delta alone equals its delta in a batch to the bit, and two launches,
// or a graph replay and an eager call, agree to the bit.
//
// Thread-block clusters were kept over a per-stream scratch of partials
// summed by a tile's last block: the reduction stays inside one launch
// and needs nothing from the caller.
//
// What timing taught (tools/flash_variants.py --only lora, cold, at the
// 136-row tick; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): the A side
// takes ~0.0103 ms and the B side ~0.0072, of which launch and schedule
// (a body that leaves after find_tile) are ~0.0029 each and the cluster
// reduction ~0.0014; the slices' loads and products take the rest, and
// fewer slices cost more (SPLIT 4: 0.0154, SPLIT 1: 0.0461). One bulk
// copy a row (cp.async.bulk on an mbarrier) in place of the 16-byte
// cp.async was no faster; SPLIT 16 (a non-portable cluster) 0.0093.
#pragma once

#include <cooperative_groups.h>

#include "mma_gemm.cuh"

namespace ptt {
namespace moe_lora {

namespace cg = cooperative_groups;

constexpr int TILE = 16;             // rows a tile
constexpr int SPLIT = 8;             // K slices a tile = blocks a cluster
constexpr int THREADS = 256;
constexpr int STAGES = 4;            // chunks of the A body's ring
constexpr int SPLIT_K_MAX_N = 64;    // the A body's widest output
constexpr int WIDE_MAX_K = 64;       // the B body's deepest reduction
constexpr int SPAN = 512;            // the B body's columns a block
constexpr int ROWS_A_THREAD = TILE / (THREADS / (SPAN / 4));   // 8

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// the K slice of each cluster block: a function of K alone
__host__ __device__ constexpr int slice_width(int K) {
  return (cdiv(K, SPLIT) + 3) & ~3;
}

// the A body's chunk depth: 128 floats up to N 32, 64 above
__host__ __device__ constexpr int chunk_depth(int N) {
  return N <= 32 ? 128 : 64;
}

// the A body's dynamic shared memory: STAGES chunks of the tile's rows
// (padded by 4 floats against bank conflicts) and the group's A rows
__host__ __device__ constexpr size_t split_k_smem(int KC, int N) {
  return sizeof(float) * STAGES * ((size_t)TILE * (KC + 4) + (size_t)KC * N);
}

// the B body's: B's span [K, SPAN] and the tile's rows [TILE, K]
__host__ __device__ constexpr size_t wide_smem(int K) {
  return sizeof(float) * ((size_t)K * SPAN + (size_t)TILE * K);
}

struct Args {
  const float* x;    // [s, K] gathered or [m, K] sorted rows
  const int* src;    // gather indices [m] or null
  const float* w;    // [e, K, N]
  const int* gs;     // [e]
  const int* dst;    // scatter indices [m] or null
  float* out;        // [m, N]
  int m, K, N, e;
};

// rows [r0, r1) of a tile: of group g (g >= 0), or rows no group owns
// (g < 0, zeros); r0 >= r1 for a surplus block
struct Tile {
  int g, r0, r1;
};

// exclusive prefix of v over the block's threads; total: the sum of all
__device__ __forceinline__ int block_exclusive(int v, int* part,
                                               int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int p = part[w];
    if (w < warp) before += p;
    total += p;
  }
  __syncthreads();   // part is free again
  return before + inc - v;
}

// tile t of the device schedule: group g's rows (clamped to m) in tiles
// of TILE, groups in order, then the rows no group owns; every thread of
// the block calls it (sh: THREADS / 32 + 3 ints of shared memory)
__device__ __forceinline__ Tile find_tile(const int* __restrict__ gs, int e,
                                          int m, int t, int* sh) {
  const int per = cdiv(e, THREADS);
  const int g0 = min((int)threadIdx.x * per, e), g1 = min(g0 + per, e);
  int* res = sh + THREADS / 32;
  int rows = 0;
  for (int g = g0; g < g1; ++g) rows += max(gs[g], 0);
  int rows_total, tiles_total;
  const int start = block_exclusive(rows, sh, rows_total);
  int tiles = 0;
  for (int g = g0, s = start; g < g1; ++g) {
    const int n = max(gs[g], 0);
    tiles += cdiv(min(s + n, m) - min(s, m), TILE);
    s += n;
  }
  if (threadIdx.x == 0) res[0] = -2;   // ordered by the scan's barriers
  const int first = block_exclusive(tiles, sh, tiles_total);
  if (t >= first && t < first + tiles) {
    for (int g = g0, s = start, f = first; g < g1; ++g) {
      const int n = max(gs[g], 0);
      const int a = min(s, m), b = min(s + n, m), c = cdiv(b - a, TILE);
      if (t < f + c) {
        const int r0 = a + (t - f) * TILE;
        res[0] = g;
        res[1] = r0;
        res[2] = min(r0 + TILE, b);
        break;
      }
      f += c;
      s += n;
    }
  }
  __syncthreads();
  if (res[0] != -2) return Tile{res[0], res[1], res[2]};
  const int r0 = min(rows_total, m) + (t - tiles_total) * TILE;
  return Tile{-1, r0, min(r0 + TILE, m)};
}

__device__ __forceinline__ void fma4(float4& acc, float x, const float4& b) {
  acc.x = fmaf(x, b.x, acc.x);
  acc.y = fmaf(x, b.y, acc.y);
  acc.z = fmaf(x, b.z, acc.z);
  acc.w = fmaf(x, b.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& b) {
  acc.x += b.x;
  acc.y += b.y;
  acc.z += b.z;
  acc.w += b.w;
}

// out[r] = x[src[r] or r] @ w[g(r)], N <= SPLIT_K_MAX_N; KC = chunk_depth(N)
template <int KC>
__global__ void __launch_bounds__(THREADS) moe_gmm_split_k(Args a) {
  extern __shared__ __align__(16) unsigned char lora_smem[];
  __shared__ int sh[THREADS / 32 + 3];
  __shared__ int rows_s[TILE];
  float* ring = reinterpret_cast<float*>(lora_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, s = (int)cluster.block_rank();
  const Tile tile = find_tile(a.gs, a.e, a.m, blockIdx.x, sh);
  if (tile.r0 >= tile.r1) return;   // the whole cluster leaves
  const int N = a.N, NQ = N / 4, K = a.K;
  if (tile.g < 0) {   // rows no group owns: each block its share
    for (int i = s * THREADS + tid; i < (tile.r1 - tile.r0) * NQ;
         i += SPLIT * THREADS)
      reinterpret_cast<float4*>(a.out + (size_t)(tile.r0 + i / NQ) * N)
          [i % NQ] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int nr = tile.r1 - tile.r0;
  if (tid < TILE)
    rows_s[tid] = tid < nr ? (a.src ? a.src[tile.r0 + tid] : tile.r0 + tid)
                           : -1;
  __syncthreads();

  const int W = slice_width(K);
  const int k0 = min(s * W, K), len = min(k0 + W, K) - k0;
  const int nch = cdiv(len, KC);
  const float* w = a.w + (size_t)tile.g * K * N;
  constexpr int XS = KC + 4;
  const int stage = TILE * XS + KC * N;
  auto issue = [&](int c) {
    float* xs = ring + (c % STAGES) * stage;
    float* as = xs + TILE * XS;
    const int kb = k0 + c * KC, kn = min(KC, len - c * KC);
    for (int i = tid; i < TILE * (KC / 4); i += THREADS) {
      const int r = i / (KC / 4), q = (i % (KC / 4)) * 4;
      const int sr = rows_s[r];
      const bool ok = sr >= 0 && q < kn;
      cp_async16(xs + r * XS + q, ok ? a.x + (size_t)sr * K + kb + q : a.x,
                 ok);
    }
    for (int i = tid; i < KC * NQ; i += THREADS) {
      const int kk = i / NQ, q = (i % NQ) * 4;
      const bool ok = kk < kn;
      cp_async16(as + kk * N + q, ok ? w + (size_t)(kb + kk) * N + q : w,
                 ok);
    }
  };

  // thread (j, p): row p / NQ, columns 4 (p % NQ) .. + 3, every KS-th
  // group of 4 k from j
  const int P = TILE * NQ, KS = THREADS / P;
  const int p = tid % P, j = tid / P;
  const int r = p / NQ, cq = p % NQ;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c = 0; c < STAGES; ++c) {
    if (c < nch) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<STAGES - 1>();   // chunk c has landed ...
    __syncthreads();               // ... for every thread
    const float* xs = ring + (c % STAGES) * stage;
    const float* as = xs + TILE * XS;
    const int kq = min(KC, len - c * KC) / 4;
    if (j < KS) {
      for (int k4 = j; k4 < kq; k4 += KS) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + r * XS + 4 * k4);
        const float* ap = as + 4 * k4 * N + 4 * cq;
        const float4 b0 = *reinterpret_cast<const float4*>(ap);
        const float4 b1 = *reinterpret_cast<const float4*>(ap + N);
        const float4 b2 = *reinterpret_cast<const float4*>(ap + 2 * N);
        const float4 b3 = *reinterpret_cast<const float4*>(ap + 3 * N);
        fma4(acc, xv.x, b0);
        fma4(acc, xv.y, b1);
        fma4(acc, xv.z, b2);
        fma4(acc, xv.w, b3);
      }
    }
    __syncthreads();   // every thread is done with chunk c's stage
    if (c + STAGES < nch) issue(c + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the KS shares in order, into red[p] (the ring is free)
  float4* red = reinterpret_cast<float4*>(ring);
  if (j < KS) red[j * P + p] = acc;
  __syncthreads();
  if (tid < P) {
    float4 v = red[p];
    for (int q = 1; q < KS; ++q) add4(v, red[q * P + p]);
    red[p] = v;
  }
  cluster.sync();   // every block's partial is in its shared memory
  const int share = cdiv(P, SPLIT), pp = s * share + tid;
  if (tid < share && pp < P) {
    float4 v[SPLIT];
#pragma unroll
    for (int q = 0; q < SPLIT; ++q) v[q] = cluster.map_shared_rank(red, q)[pp];
#pragma unroll
    for (int q = 1; q < SPLIT; ++q) add4(v[0], v[q]);
    const int rr = pp / NQ;
    if (rr < nr)
      reinterpret_cast<float4*>(a.out + (size_t)(tile.r0 + rr) * N)
          [pp % NQ] = v[0];
  }
  cluster.sync();   // no block leaves while another reads its partial
}

// out[dst[r]] = x[r] @ w[g(r)], K <= WIDE_MAX_K
__global__ void __launch_bounds__(THREADS) moe_gmm_wide_scatter(Args a) {
  extern __shared__ __align__(16) unsigned char lora_smem[];
  __shared__ int sh[THREADS / 32 + 3];
  __shared__ int dst_s[TILE];
  const Tile tile = find_tile(a.gs, a.e, a.m, blockIdx.x, sh);
  if (tile.r0 >= tile.r1) return;
  const int tid = threadIdx.x, N = a.N, K = a.K, nr = tile.r1 - tile.r0;
  const int cq = tid % (SPAN / 4), r0 = (tid / (SPAN / 4)) * ROWS_A_THREAD;
  const int c0 = blockIdx.y * SPAN, col = c0 + 4 * cq;
  if (tid < TILE) dst_s[tid] = tid < nr ? a.dst[tile.r0 + tid] : -1;
  if (tile.g < 0) {   // rows no group owns
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_A_THREAD; ++i)
      if (r0 + i < nr && col < N)
        *reinterpret_cast<float4*>(a.out + (size_t)dst_s[r0 + i] * N + col) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  float* bs = reinterpret_cast<float*>(lora_smem);   // [K][SPAN]
  float* xs = bs + K * SPAN;                          // [TILE][K]
  const float* w = a.w + (size_t)tile.g * K * N;
  for (int i = tid; i < K * (SPAN / 4); i += THREADS) {
    const int kk = i / (SPAN / 4), q = (i % (SPAN / 4)) * 4;
    const bool ok = c0 + q < N;
    cp_async16(bs + kk * SPAN + q, ok ? w + (size_t)kk * N + c0 + q : w, ok);
  }
  for (int i = tid; i < TILE * (K / 4); i += THREADS) {
    const int rr = i / (K / 4), q = (i % (K / 4)) * 4;
    const bool ok = rr < nr;
    cp_async16(xs + rr * K + q,
               ok ? a.x + (size_t)(tile.r0 + rr) * K + q : a.x, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float4 acc[ROWS_A_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_A_THREAD; ++i)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k4 = 0; k4 < K / 4; ++k4) {
    const float* bp = bs + 4 * k4 * SPAN + 4 * cq;
    const float4 b0 = *reinterpret_cast<const float4*>(bp);
    const float4 b1 = *reinterpret_cast<const float4*>(bp + SPAN);
    const float4 b2 = *reinterpret_cast<const float4*>(bp + 2 * SPAN);
    const float4 b3 = *reinterpret_cast<const float4*>(bp + 3 * SPAN);
#pragma unroll
    for (int i = 0; i < ROWS_A_THREAD; ++i) {
      const float4 xv =
          *reinterpret_cast<const float4*>(xs + (r0 + i) * K + 4 * k4);
      fma4(acc[i], xv.x, b0);
      fma4(acc[i], xv.y, b1);
      fma4(acc[i], xv.z, b2);
      fma4(acc[i], xv.w, b3);
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS_A_THREAD; ++i)
    if (r0 + i < nr && col < N)
      *reinterpret_cast<float4*>(a.out + (size_t)dst_s[r0 + i] * N + col) =
          acc[i];
}

// an upper bound of the schedule's tiles, from host ints: the groups'
// tiles number at most ceil(covered / TILE) + e - 1 and the uncovered
// rows' at most ceil((m - covered) / TILE), together ceil(m / TILE) + e
inline int tile_bound(int m, int e) { return cdiv(m, TILE) + e; }

template <int KC>
cudaError_t launch_split_k_kc(const Args& a, cudaStream_t st) {
  // the attribute is set to the instance's largest need, so a graph
  // captured at one N replays after a call at another
  cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_split_k<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)split_k_smem(KC, KC == 128 ? 32 : SPLIT_K_MAX_N));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tile_bound(a.m, a.e), SPLIT);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = split_k_smem(KC, a.N);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = SPLIT;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, moe_gmm_split_k<KC>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the launches take what moe_gmm.cu's run() and f32_body pass: K and N
// multiples of 8, N <= SPLIT_K_MAX_N here, K <= WIDE_MAX_K and dst_rows
// for the scatter
inline cudaError_t launch_split_k(const Args& a, cudaStream_t st) {
  return chunk_depth(a.N) == 128 ? launch_split_k_kc<128>(a, st)
                                 : launch_split_k_kc<64>(a, st);
}

inline cudaError_t launch_wide_scatter(const Args& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_wide_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)wide_smem(WIDE_MAX_K));
  if (err != cudaSuccess) return err;
  const dim3 grid(tile_bound(a.m, a.e), cdiv(a.N, SPAN));
  moe_gmm_wide_scatter<<<grid, THREADS, wide_smem(a.K), st>>>(a);
  return cudaGetLastError();
}

}  // namespace moe_lora
}  // namespace ptt
