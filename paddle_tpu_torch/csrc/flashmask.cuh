// The FlashMask column mask of K6 (flashmask_fwd.cu, flashmask_bwd.cu):
// key column j of mask row r hides query rows [start_j, end_j) (end_j =
// Lq with one bound), on top of the causal triangle and the tails. Mask
// row r = b * Hm + h / (H / Hm) serves query head h of batch b.
//
// The tile skip is what makes a document mask cheap. tile_bounds_kernel
// reduces each 64-column kv tile of each mask row to {max start, min
// end}, once in the forward's entry; the backward's entries read the
// summary the forward left. A (q tile, 64-column kv tile) pair is dead
// when max(start) <= q_first and min(end) > q_last, as the TPU kernel's
// _block_live. Then:
// - the forward and dq blocks (one q tile each) set one live bit per kv
//   tile in shared memory and walk the set bits only; the bf16 forward's
//   128-column tiles are live when either 64-column half is
//   (init_live<2>);
// - the dk/dv block (one kv tile) turns the pair of each query head of
//   its group into the range [lo, hi) of dead q tiles, which its walk
//   over (head, q tile) items jumps; the bf16 dk/dv block's 128-column
//   kv tiles take the intersection of their halves' ranges
//   (init_dead<2>).
// The start / end values of the kv tile being computed are staged in
// shared memory beside K and V (by cp.async in the float32 kernels, by
// the bf16 kernels' producer warp with load_bounds, which also says
// whether any column hides a row of the q tile), and sees() adds
// !(start_j <= i < end_j) to each entry's predicate, so a masked entry
// is set to exactly NEG_INF (forward) or P = 0 (backward) as the
// kernels' guards require.
#pragma once

#include <climits>

#include "flash_attention.cuh"

namespace ptt {
namespace fa {

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

struct ColumnMask {
  static constexpr bool kOn = true;
  static constexpr int kBoundInts = 2 * TILE;
  const int* start;   // [B * Hm, Lk]
  const int* end;     // [B * Hm, Lk]
  const int2* tiles;  // [B * Hm, n_kt]: {max start, min end} of a kv tile
  int Hm, Lk, n_kt;

  __host__ __device__ int live_words() const { return (n_kt + 31) / 32; }
  __host__ __device__ int dead_ints(int rep) const { return 2 * rep; }

  __device__ int row(int b, int h, int H) const {
    return b * Hm + h / (H / Hm);
  }

  // bit t of live (t < n): some row of [q_first, q_last] sees a column
  // of kv tile t, a tile of S 64-column summary tiles (live iff one of
  // them is); the caller syncs before reading it
  template <int S = 1>
  __device__ void init_live(unsigned* live, int mrow, int n, int q_first,
                            int q_last) const {
    const int lane = threadIdx.x % 32;
    for (int w = threadIdx.x / 32; w < (n + 31) / 32;
         w += blockDim.x / 32) {
      const int t = w * 32 + lane;
      bool on = false;
#pragma unroll
      for (int u = 0; u < S; ++u)
        if (t < n && t * S + u < n_kt) {
          const int2 tb = tiles[(size_t)mrow * n_kt + t * S + u];
          on |= !(tb.x <= q_first && tb.y > q_last);
        }
      const unsigned bits = __ballot_sync(FULL_MASK, on);
      if (lane == 0) live[w] = bits;
    }
  }

  // the first live tile >= t, or n (every thread gets the same answer)
  __device__ int next_live(const unsigned* live, int t, int n) const {
    while (t < n) {
      const unsigned w = live[t >> 5] >> (t & 31);
      if (w) return t + __ffs(w) - 1;   // bits past n are 0
      t = (t | 31) + 1;
    }
    return n;
  }

  // dead[2 hi], dead[2 hi + 1]: the 64-row q tiles [lo, hi) every row of
  // which is masked on every column of kv tile kt, a tile of S 64-column
  // summary tiles, for head hi of the group: the intersection of the
  // halves' ranges (a range is empty when lo >= hi); the caller syncs
  // before reading them
  template <int S = 1>
  __device__ void init_dead(int* dead, int b, int hk, int rep, int H,
                            int kt, int Lq) const {
    const int n_qt = (Lq + TILE - 1) / TILE;
    for (int hi = threadIdx.x; hi < rep; hi += blockDim.x) {
      int lo = 0, up = n_qt;
#pragma unroll
      for (int u = 0; u < S; ++u) {
        if (kt * S + u >= n_kt) break;   // no columns there: no limit
        const int2 tb =
            tiles[(size_t)row(b, hk * rep + hi, H) * n_kt + kt * S + u];
        // q0 >= max start  <=>  qt >= ceil(max start / 64)
        lo = max(lo, tb.x <= 0 ? 0
                               : (int)(((long long)tb.x + TILE - 1) / TILE));
        // q_last < min end  <=>  qt < floor(min end / 64), or every tile
        up = min(up, tb.y >= Lq ? n_qt : (tb.y <= 0 ? 0 : tb.y / TILE));
      }
      dead[2 * hi] = lo;
      dead[2 * hi + 1] = up;
    }
  }

  // the first item >= u (item = head * n_qt + q tile - qt0) outside its
  // head's dead range, or n_items
  __device__ int next_item(const int* dead, int u, int n_qt, int qt0,
                           int n_items) const {
    while (u < n_items) {
      const int hi = u / n_qt, qt = qt0 + u % n_qt;
      const int lo = dead[2 * hi], up = dead[2 * hi + 1];
      if (qt < lo || qt >= up) return u;
      u += up - qt;   // at most to the next head's first item
    }
    return n_items;
  }

  // bounds of kv tile k0 in mask row mrow -> bs[0, 64) start, bs[64,
  // 128) end (0 past Lk) by cp.async; the caller commits and waits
  __device__ void stage(int* bs, int mrow, int k0) const {
    for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
      const bool ok = k0 + r < Lk;
      const size_t off = (size_t)mrow * Lk + (ok ? k0 + r : 0);
      cp_async4(bs + r, start + off, ok);
      cp_async4(bs + TILE + r, end + off, ok);
    }
  }

  // bounds of the W columns k0.. of mask row mrow -> bs[0, W) start,
  // bs[W, 2 W) end (0 past Lk), by the 32 lanes of one warp with plain
  // loads; returns to every lane whether some column hides a row of
  // [q_first, q_last] (if not, the tile needs no per-entry mask)
  template <int W>
  __device__ bool load_bounds(int* bs, int mrow, int k0, int q_first,
                              int q_last) const {
    bool hides = false;
    for (int r = threadIdx.x % 32; r < W; r += 32) {
      const bool ok = k0 + r < Lk;
      const size_t off = (size_t)mrow * Lk + k0 + r;
      const int s = ok ? start[off] : 0, e = ok ? end[off] : 0;
      bs[r] = s;
      bs[W + r] = e;
      hides |= s < e && s <= q_last && q_first < e;
    }
    return __any_sync(FULL_MASK, hides);
  }

  // row i sees column k0 + jl of the staged tile of W columns
  template <int W = TILE>
  __device__ bool sees(const int* bs, int jl, int i) const {
    return !(bs[jl] <= i && i < bs[W + jl]);
  }
};

// tiles[item] = {max start, min end} over the columns j < Lk of one
// (mask row, 64-column tile) item, one warp an item
__global__ void __launch_bounds__(128)
    tile_bounds_kernel(const int* __restrict__ start,
                       const int* __restrict__ end, int2* __restrict__ tiles,
                       size_t n_items, int Lk, int n_kt) {
  const size_t item = (size_t)blockIdx.x * 4 + threadIdx.x / 32;
  if (item >= n_items) return;   // the whole warp leaves together
  const size_t r = item / n_kt;
  const int t = (int)(item % n_kt), lane = threadIdx.x % 32;
  int mx = INT_MIN, mn = INT_MAX;
  for (int c = lane; c < TILE; c += 32) {
    const int j = t * TILE + c;
    if (j < Lk) {
      mx = max(mx, start[r * Lk + j]);
      mn = min(mn, end[r * Lk + j]);
    }
  }
  mx = __reduce_max_sync(FULL_MASK, mx);
  mn = __reduce_min_sync(FULL_MASK, mn);
  if (lane == 0) tiles[item] = make_int2(mx, mn);
}

// fill the tile summary of B * Hm mask rows over Lk columns on the
// stream (K6f's entry does, once a forward + backward)
inline cudaError_t tile_summary(const void* start, const void* end,
                                void* tiles, int B, int Hm, int Lk,
                                cudaStream_t stream) {
  const int n_kt = (Lk + TILE - 1) / TILE;
  const size_t n_items = (size_t)B * Hm * n_kt;
  tile_bounds_kernel<<<(unsigned)((n_items + 3) / 4), 128, 0, stream>>>(
      (const int*)start, (const int*)end, (int2*)tiles, n_items, Lk, n_kt);
  return cudaGetLastError();
}

// the mask of Hm rows a batch over Lk columns, its tile summary filled
inline ColumnMask column_mask(const void* start, const void* end,
                              const void* tiles, int Hm, int Lk) {
  return ColumnMask{(const int*)start, (const int*)end, (const int2*)tiles,
                    Hm, Lk, (Lk + TILE - 1) / TILE};
}

}  // namespace fa
}  // namespace ptt
