// The bf16-query body of the paged attention kernels for Hopper (sm_90a),
// included by ragged_paged_attention.cu (K2r) and
// paged_decode_attention.cu (K2d, K2v):
//
//   out[row, h] = softmax(scale * q[row, h] K^T) V over the positions
//   < ctx[s] + t of slot s's pages of the pool [NB, BS, Hkv, D] (kv head
//   h / rep), for row t of slot s: the ragged rows of a serving tick
//   (K2r: slot s owns rows starts[s] .. starts[s] + q_lens[s]), or a
//   window of TW tokens a slot of q [S, TW, H, D] (K2v; K2d is TW = 1).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py, _ragged_kernel
// (call :593, with its per-slot tree mask, :339-355) and _decode_kernel
// (calls :439, t_q 1, and :510, t_q T, with its tree mask, :255-270):
// bf16 pools, float32 pools under a bf16 q (the mode of GPT's caches:
// the dot_general promotes to float32, :329-347), and the `quantized` mode
// (int8 pools with a float32 scale a position and kv head, dequantized
// tile by tile by _dequant_tile, :184).
//
// The tree mode (tree_bits, T masks): row t < T of a tree slot keeps
// column c iff c < ctx (the committed prefix and the root) or bit c - ctx
// of its ancestor mask is set. K2v's windows are all tree slots; in K2r
// a slot is one iff its flag (tslots[s] > 0, the reference's tree_ref) is
// set, so one launch mixes tree windows with linear prefill chunks and
// their trickle rows. A node's ancestors have ids of at most its own, so
// the mask is a subset of the linear bound c < ctx + t: the visible
// positions, stages and splits stay the linear window's. The masks ride
// in Params (32 words, no global read; copied to shared memory at
// constant offsets). With the tile's Q, each query vector's (lo, mask) is
// staged in shared memory: lo the row's bound (linear) or ctx (tree), the
// mask its ancestors cut at the table's reach; the slot's flag is read
// there once, and whether the item holds tree rows is a word of shared
// memory, so no register carries it across the stages. On an edge stage
// a linear row keeps c < lo, a tree row c < lo or bit c - lo of its mask;
// in a tree item every stage past ctx is an edge stage. The three paths
// (tree edge, linear edge, no edge) are uniform branches. The tree mode is
// a template instance of its own (TREE), so linear launches run a body
// without any of it. On an H100: the two rows' bound and mask held in
// registers for the whole item made ptxas spill at D 128; one predicate
// for both modes, or one that must prove a no-edge stage unmasked, cost
// the linear kernels 9-74 %; the tree paths compiled into the linear
// body, 1-4 % (PERF.md).
//
// What bounds it on the H100: bytes. A decode row reads a page's K and V
// (2 x BS x D x 2 bytes a kv head) for rep query heads: ~rep flops a
// byte, far under the ~295 where the tensor cores become the limit. A
// prefill chunk's tile of 64 query vectors does 64 flops a byte, under
// it too, so the least time is the live K/V bytes (+ q and out) over
// 3.35 TB/s, and the work is to keep every SM's share of those bytes in
// flight and to read each page once per tile of query vectors.
//
// Design (persistent, warp-specialised; hopper.cuh's pieces):
// - Query vectors of a kv group are packed into the M dimension of the
//   tensor-core products: a tile is up to 64 (window row t, query head r
//   of the group) pairs, row-major in t, so TQ = 64 / rep rows (16 at
//   rep 4, 9 at rep 7 with one dead vector, 64 at rep 1) share each page
//   read. A work item is (slot, kv head, tile, split of the positions).
// - Splits: a slot whose live rows fit one tile (decode rows, verify
//   windows) has its visible positions cut into splits of k stages, so
//   a long context is read by many SMs at once; a slot of several tiles
//   (a prefill chunk) is not split: its tiles x kv heads already spread
//   it. k is the fewest stages a split for which all items fit one wave
//   of the grid (Cfg::BLOCKS blocks an SM), found by every block from
//   q_lens and ctx by bisection: the work ends after one item a block
//   whatever the contexts, with the shortest splits that allows. Each
//   split's (m, l, unnormalised o) goes to the caller's scratch, a
//   record an item; the split that finishes last (an arrival counter a
//   (slot, kv head), in the scratch, which it resets) merges them all,
//   its own too, in split order (two calls give the same bits), a thread
//   a (query vector, 4 columns) with four splits' loads in flight. No
//   block waits on another; one launch a call.
// - Schedule: persistent blocks; items are ordered slot by slot, slots
//   by descending live rows (prefill tiles before decode splits), and
//   dealt to the blocks in a snake (block b takes items b, 2G - 1 - b,
//   2G + b, ...) where they exceed a wave, so a block that took a heavy
//   item early takes a light one late. Every block derives the same list
//   in shared memory; nothing is read on the host.
// - A producer warp streams each item's positions in stages of 64
//   through a ring of STAGES slots (2 at D 128, 4 at D 64: with Q, two
//   blocks fill an SM's shared memory; at 168 registers a thread, the
//   most that two blocks of 5 warps leave each, a consumer holds S, P
//   and O but not Q) ("full" mbarriers completed by TMA,
//   "empty" ones by the 4 consumer warps): for each stage, 64 / BS pages
//   read from the slot's table row by as many lanes, each lane issuing
//   its page's K and V as D / 64 TMA boxes (64 columns, 1 kv head, BS
//   rows) of a 4-D map over the pool, 128-byte swizzled. A page is BS x
//   128 bytes, a whole number of 1024-byte swizzle groups, so the pages
//   of a stage compose into the K-major tile that wgmma reads. A page
//   past the item's last visible position is never read: it is loaded
//   at block coordinate NB, past the pool, which TMA fills with zeros
//   (so V's rows there are finite zeros under a zero P). On an H100 a
//   stage took as long with one block an SM and a six-stage ring, with
//   two consumer warpgroups taking turns on stages, and with S issued
//   beside the last stage's P V; it grew with the TMA boxes a stage
//   (BS 8 slowest), so this design keeps the simplest of them.
// - The consumer warpgroup stages the tile's Q in shared memory once an
//   item (swizzled as TMA would put it; dead vectors zero) and for each
//   stage: S = Q K^T by wgmma m64n64k16 (both K-major), the online softmax
//   in registers in the log2 domain, masked only on stages that reach
//   past the tile's first row's bound (row t's bound is min(ctx + t,
//   MB * BS); a masked entry is exactly NEG_INF and its P exactly 0), P
//   rounded to bf16 in registers (the TPU kernel's p.astype(v.dtype))
//   as the A operand of O += P V by wgmma m64n{D}k16 with V read through
//   the descriptor's transpose bit. A vector that sees no position
//   writes 0.
// - Host: the pool's tensor maps are kept by address, shape and element
//   type, the SM count and the kernel's attribute asked once a device.
//
// int8 pools (INT8): a position-head costs 2 x (D + 4) bytes (264 at D 128,
// against 512 in bf16), so the bound halves. int8 values are exact in
// bf16 and the scales factor out of both products, so the tensor cores
// still take bf16:
// - each page's K and V land by TMA as int8 rows (a UINT8 map, no
//   swizzle: D bytes a row), and their 64 + 64 scales by cp.async from
//   the producer's lanes, arriving on the stage's full barrier (a page
//   past the item's last position: zeros, its scales never read); this
//   takes any Hkv (a TMA box of one head's scales would be 4 bytes wide);
// - the consumer warpgroup converts the stage's int8 K and V into one
//   bf16 tile in the atom layout above (16 values a thread a step), copies
//   the scales beside it and frees the stage; then fence.proxy.async, a
//   consumer-only named barrier, and the same wgmma products;
// - S's column c is multiplied by K's scale of position c in the
//   softmax; V's scale folds into P before P V (P' = P x vs; l sums P).
//   The reference keeps P in float32 through P V: P' goes as hi + lo
//   bf16 halves (P_SPLIT: two P V products, ~2^-17 relative; rounded
//   once, ~2^-9, was 2-9 % faster and ~3x further from the float32
//   recipe on an H100). Ring: 3 stages at D 128, 4 at D 64; with Q and
//   the converted tile two blocks still fit an SM.
// float32 pools (F32: a bf16 q over GPT's float32 pools): the TPU kernel
// computes this mode in float32 (dot_general of the bf16 q against the f32
// K promotes to f32; p.astype(v.dtype) keeps P float32 against the f32 V;
// only the output is rounded). A bf16 q is exact in bf16, K, V and P are
// not, so the tensor cores take each as two bf16 halves, x = hi + lo with
// hi = bf16(x), lo = bf16(x - hi) (~2^-16 relative):
// - each page's K and V land by TMA as float32 rows (a FLOAT32 map, no
//   swizzle: D x 4 bytes a row, one box a page, as int8's; a swizzled map
//   caps a box at 32 floats, so a page would take D / 32 boxes each, and
//   the conversion reads the rows linearly without bank conflicts anyway);
// - the consumer warpgroup rewrites each 8-position group of K and V in
//   place: its 8 float32 rows (8 x D x 4 bytes) become the bf16 hi atoms'
//   8 rows, then the lo atoms' (the same bytes), swizzled as TMA puts a
//   bf16 tile. So a group is read and written by one warp (a warp-local
//   exchange, no block barrier), and hi and lo are wgmma operands whose
//   8-row groups lie 8 x D x 4 bytes apart (the descriptors' SBO);
// - S = Q K_hi^T + Q K_lo^T (two passes into one accumulator); P is split
//   as int8's P_SPLIT splits it, and O += P_hi V_hi + P_lo V_hi + P_hi V_lo
//   (V through the transpose bit); the dropped P_lo V_lo is ~2^-16;
// - a stage is freed after its P V, as bf16's. Ring: 2 stages at D 64 (a
//   stage is 32 KB: Q, 2 stages and the slot tables fill half an SM, so
//   two blocks an SM, the bf16 instance's 64 KB ring; a third stage is
//   704 bytes past the budget), 3 at D 128 with one block an SM (a stage
//   is 64 KB); the persistent grid and the wrapper's split records follow
//   Cfg::BLOCKS.
#pragma once

#include <algorithm>
#include <mutex>

#include "flash_attention_fwd_sm90.cuh"
#include "hopper.cuh"

namespace ptt {
namespace pa90 {
// internal to each source that includes it: the host statics below (the
// shared-memory attribute's bit, the map cache) must be per library, as
// each library has its own copy of the kernel
namespace {

using bf16 = __nv_bfloat16;
using fa::NEG_INF;

constexpr int BN = 64;            // positions of a stage
constexpr int MQ = 64;            // query vectors of a tile
constexpr int THREADS = 160;      // consumer warpgroup + producer warp
constexpr int MAX_SLOTS = 512;    // slots a call (the shared slot tables)
constexpr int ATOM_BYTES = BN * 64 * 2;   // 64 positions x 64 columns
constexpr int MAX_TREE = 32;      // tree-mode window rows (32 mask bits)
// int8 pools: P V as two products of P's bf16 hi and lo halves (true),
// or of P rounded to bf16 once (false)
constexpr bool P_SPLIT = true;

// the pool kinds: bf16 pages, int8 pages with float32 scales, float32
// pages (a bf16 q over float32 pools)
enum Pool { BF16 = 0, INT8 = 1, F32 = 2 };

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// D: the head dim; POOL: the pool kind
template <int D, int POOL>
struct Cfg {
  static constexpr int NA = D / 64;                      // column atoms
  static constexpr int Q_BYTES = NA * ATOM_BYTES;         // 64 vectors
  static constexpr int ES = POOL == INT8 ? 1 : POOL == F32 ? 4 : 2;
  static constexpr int KV_BYTES = BN * D * ES;   // a stage's K (V) rows
  // bf16: K then V atoms; int8 / f32: K then V rows as they lie (int8:
  // then K's 64 scales and V's)
  static constexpr int STAGE_BYTES =
      2 * KV_BYTES + (POOL == INT8 ? 2 * BN * 4 : 0);
  static constexpr uint32_t TX_BYTES = 2 * KV_BYTES;
  // int8: the converted bf16 K and V atoms and the stage's scales
  static constexpr int CONV_BYTES =
      POOL == INT8 ? 2 * NA * ATOM_BYTES + 2 * BN * 4 : 0;
  // the operand tiles of K and V: from one 64-column atom to the next,
  // from 8 positions to the next 8 (the descriptors' SBO), from K's tile
  // to V's, and (f32) from a hi atom to its lo atom
  static constexpr int ATOM_STEP = POOL == F32 ? 1024 : ATOM_BYTES;
  static constexpr int GROUP = POOL == F32 ? 8 * D * 4 : 1024;
  static constexpr int V_TILE = POOL == INT8 ? NA * ATOM_BYTES : KV_BYTES;
  static constexpr int LO = NA * 1024;
  static constexpr int BLOCKS = POOL == F32 && D == 128 ? 1 : 2;   // an SM
  static constexpr int STAGES =
      POOL == INT8  ? (D == 128 ? 3 : 4)
      : POOL == F32 ? (D == 128 ? 3 : 2)
                    : 65536 / STAGE_BYTES;   // 2 at D 128
  static constexpr size_t SMEM = 1024 + Q_BYTES + CONV_BYTES +
                                 (size_t)STAGES * STAGE_BYTES +
                                 2 * STAGES * sizeof(uint64_t) +
                                 sizeof(int) *
                                     (4 * MAX_SLOTS + 4 + 2 * MQ + MAX_TREE);
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "BLOCKS blocks an SM");
};

struct Params {
  const bf16* q;
  bf16* out;
  const float* kscale;  // int8 pools: [NB, BS, Hkv] each
  const float* vscale;
  const int* tables;    // [S, MB]
  const int* ctx;       // [S]: positions row 0 of the slot sees
  const int* qlens;     // [S] or null: every slot has TW rows
  const int* starts;    // [S] or null: slot s's rows start at s * TW
  float* part;          // split partials: part_items records of NV vectors
  int* counters;        // [S * Hkv] zeros; each call leaves them zero
  int S, H, Hkv, rep, BS, MB, NB;
  int w_max;            // rows a slot at most (TW for K2v / K2d)
  int TQ, NV;           // rows a tile; vectors a split partial holds
  int part_items;       // items whose partials the scratch holds
  float scale_log2;
  int tree;             // tree mode: rows t < tree of a tree slot masked by
  uint32_t tree_bits[MAX_TREE];   // row t's ancestors tree_bits[t]
  const int* tslots;    // [S] or null: the tree slots (> 0); null: all
};

// one work item, derived alike by the producer and the consumers
struct Item {
  int s, first, g, split, ns, t0, nrows, row0, ctx, lo, hi, nst;
};

// the slot's live rows, clamped to w_max
__device__ __forceinline__ int slot_rows(const Params& p, int s) {
  const int n = p.qlens ? p.qlens[s] : p.w_max;
  return max(0, min(n, p.w_max));
}

// visible positions of the last of rows t < t1 of a slot (the table's
// reach at most)
__device__ __forceinline__ int visible(const Params& p, int ctx, int t1) {
  return max(0, min(ctx + t1 - 1, p.MB * p.BS));
}

// splits of a slot of ql rows at k stages a split: one unless its rows
// fit one tile
__device__ __forceinline__ int slot_splits(const Params& p, int ql, int ctx,
                                           int k) {
  return ql <= p.TQ ? max(1, cdiv(cdiv(visible(p, ctx, ql), BN), k)) : 1;
}

// items of a slot: a kv head's tiles, or a one-tile slot's splits
__device__ __forceinline__ int slot_items(const Params& p, int ql, int ctx,
                                          int k) {
  return ql > 0 ? p.Hkv * cdiv(ql, p.TQ) * slot_splits(p, ql, ctx, k) : 0;
}

// the items of all slots at k stages a split (warp-uniform: the lanes
// take the slots in turn and sum)
__device__ __forceinline__ int all_items(const Params& p, const int* s_ql,
                                         const int* s_ctx, int k) {
  int n = 0;
  for (int s = threadIdx.x % 32; s < p.S; s += 32)
    n += slot_items(p, s_ql[s], s_ctx[s], k);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    n += __shfl_xor_sync(FULL_MASK, n, off);
  return n;
}

__device__ __forceinline__ Item item_of(const Params& p, int i,
                                        const int* s_pre, const int* s_ord,
                                        const int* s_ql, const int* s_ctx,
                                        int k) {
  int lo = 0, hi = p.S;   // the rank r with s_pre[r] <= i < s_pre[r + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (s_pre[mid] <= i) lo = mid;
    else hi = mid;
  }
  Item w;
  w.s = s_ord[lo];
  w.first = s_pre[lo];
  const int local = i - w.first;
  const int ql = s_ql[w.s];
  w.ctx = s_ctx[w.s];
  w.row0 = p.starts ? p.starts[w.s] : w.s * p.w_max;
  w.ns = slot_splits(p, ql, w.ctx, k);
  w.g = local % p.Hkv;
  const int rest = local / p.Hkv;
  w.split = rest % w.ns;
  w.t0 = (rest / w.ns) * p.TQ;
  const int t1 = min(w.t0 + p.TQ, ql);
  w.nrows = t1 - w.t0;
  const int vis = visible(p, w.ctx, t1);
  w.lo = w.ns == 1 ? 0 : w.split * k * BN;
  w.hi = w.ns == 1 ? vis : min(w.lo + k * BN, vis);
  w.nst = w.hi > w.lo ? cdiv(w.hi - w.lo, BN) : 0;
  return w;
}

// int8 pools: a stage's int8 K and V rows ([64][D] each) into the bf16
// atoms of conv (K's, then V's; swizzled as TMA puts a bf16 tile), a
// 16-byte chunk (16 values, exact in bf16) a thread a step, and its 128
// scales beside them (at conv + 2 x NA atoms)
template <int D>
__device__ __forceinline__ void convert_stage(const unsigned char* st,
                                              unsigned char* conv, int tid) {
  constexpr int NA = D / 64, CH = D / 16;   // 16-byte chunks of a row
#pragma unroll
  for (int u = tid; u < 2 * BN * CH; u += 128) {
    const int kv = u / (BN * CH), r = (u / CH) % BN, c = u % CH;
    const uint4 x = *reinterpret_cast<const uint4*>(st + (size_t)u * 16);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t b = w[i / 2] >> (16 * (i % 2));
      o[i] = fa::pack_bf16((float)(int8_t)(b & 0xff),
                           (float)(int8_t)((b >> 8) & 0xff));
    }
    // columns 16 c .. 16 c + 15: 8-column chunks 2 (c % 4) and + 1 of
    // atom c / 4, each at its chunk XOR the row mod 8
    unsigned char* row = conv + (kv * NA + c / 4) * ATOM_BYTES + r * 128;
    const int ch = 2 * (c % 4);
    *reinterpret_cast<uint4*>(row + ((ch ^ (r % 8)) * 16)) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(row + (((ch + 1) ^ (r % 8)) * 16)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
  reinterpret_cast<float*>(conv + 2 * NA * ATOM_BYTES)[tid] =
      reinterpret_cast<const float*>(st + 2 * BN * D)[tid];
}

// x = hi + lo as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = fa::pack_bf16(a, b);
  lo = fa::pack_bf16(a - __uint_as_float(hi << 16),
                     b - __uint_as_float(hi & 0xffff0000u));
}

// float32 pools: a stage's 16 groups of 8 positions (K's 8, then V's; 8
// float32 rows of D, as TMA put them) rewritten in place as the bf16 hi
// atoms' 8 rows, then the lo atoms' (swizzled as TMA puts a bf16 tile).
// Warp w takes groups w, w + 4, ..: its lanes read all of a group's
// floats, coalesced, before any of them writes (a __syncwarp), 8 float4
// a lane at a time (16 a lane, 64 registers, made the D-64 tree instance
// spill).
template <int D>
__device__ __forceinline__ void convert_f32_stage(unsigned char* st,
                                                  int warp, int lane) {
  constexpr int NA = D / 64, F4 = D / 4;    // float4s of a row
  constexpr int PER = 8 * F4 / 32;          // float4s of a group a lane
  constexpr int ROUND = 128 / D;            // groups a round
  constexpr int GB = 8 * D * 4;             // a group's bytes
#pragma unroll
  for (int r0 = 0; r0 < 4; r0 += ROUND) {
    uint32_t hi[ROUND][PER][2], lo[ROUND][PER][2];
#pragma unroll
    for (int gi = 0; gi < ROUND; ++gi) {
      const float4* src = reinterpret_cast<const float4*>(
          st + (warp + 4 * (r0 + gi)) * GB);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float4 x = src[lane + 32 * i];
        split_bf16(x.x, x.y, hi[gi][i][0], lo[gi][i][0]);
        split_bf16(x.z, x.w, hi[gi][i][1], lo[gi][i][1]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int gi = 0; gi < ROUND; ++gi) {
      unsigned char* g = st + (warp + 4 * (r0 + gi)) * GB;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        // float4 f of row r: columns 4 f .. 4 f + 3, half of 16-byte
        // chunk (f % 16) / 2 of atom f / 16, at its chunk XOR the row
        const int j = lane + 32 * i, r = j / F4, f = j % F4;
        unsigned char* at = g + (f / 16) * 1024 + r * 128 +
                            ((((f % 16) / 2) ^ r) * 16) + (f % 2) * 8;
        *reinterpret_cast<uint2*>(at) =
            make_uint2(hi[gi][i][0], hi[gi][i][1]);
        *reinterpret_cast<uint2*>(at + NA * 1024) =
            make_uint2(lo[gi][i][0], lo[gi][i][1]);
      }
    }
  }
}

// TREE: the tree mode's instance (p.tree rows of a tree slot masked)
template <int D, int POOL, bool TREE>
__global__ void __launch_bounds__(THREADS, Cfg<D, POOL>::BLOCKS)
    paged_attention_kernel(const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Params p) {
  using namespace sm90;
  using C = Cfg<D, POOL>;
  constexpr int NA = C::NA, STAGES = C::STAGES;
  static_assert(2 * BN == 128, "a consumer thread a scale");
  extern __shared__ unsigned char pa_raw[];
  unsigned char* base = pa_raw + ((1024 - (smem_u32(pa_raw) & 1023)) & 1023);
  unsigned char* qs = base;     // Q: [NA][64 vectors][64 columns]
  unsigned char* conv = qs + C::Q_BYTES;   // int8: the converted stage
  const float* csc = reinterpret_cast<const float*>(conv + 2 * NA * ATOM_BYTES);
  unsigned char* ring = conv + C::CONV_BYTES;   // [STAGES][stage]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  int* s_ql = reinterpret_cast<int*>(empty + STAGES);   // [MAX_SLOTS]
  int* s_ctx = s_ql + MAX_SLOTS;                        // [MAX_SLOTS]
  int* s_ord = s_ctx + MAX_SLOTS;                       // [MAX_SLOTS]
  int* s_pre = s_ord + MAX_SLOTS;                       // [MAX_SLOTS + 1]
  int* s_last = s_pre + MAX_SLOTS + 1;                  // the merge flag
  int* s_k = s_last + 1;                                // stages a split
  int* s_titem = s_k + 1;                // the item holds tree rows
  // a tile's query vectors: visible below s_lo[v], and from there on the
  // bits of s_anc[v] (the linear bound: no bit; a tree's ancestors)
  int* s_lo = s_titem + 1;                              // [MQ]
  uint32_t* s_anc = reinterpret_cast<uint32_t*>(s_lo + MQ);   // [MQ]
  uint32_t* s_tree = s_anc + MQ;                  // [MAX_TREE]: p.tree_bits

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // int8: + a cp.async arrival of each producer lane
      mbar_init(full + s, POOL == INT8 ? 33 : 1);
      mbar_init(empty + s, 4);   // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  // the item list: slots ranked by descending rows (ties by index), the
  // items of each slot counted into a prefix over the ranks
  for (int s = tid; s < p.S; s += THREADS) {
    s_ql[s] = slot_rows(p, s);
    s_ctx[s] = p.ctx[s];
  }
  // the tree masks, each read at a constant offset: indexing the
  // parameter array by a register would take its address
#pragma unroll
  for (int t = 0; t < MAX_TREE; ++t)
    if (TREE && tid == t) s_tree[t] = p.tree_bits[t];
  __syncthreads();
  for (int s = tid; s < p.S; s += THREADS) {
    int r = s;
    if (p.qlens) {
      const int q = s_ql[s];
      r = 0;
      for (int u = 0; u < p.S; ++u) {
        const int qu = s_ql[u];
        r += qu > q || (qu == q && u < s);
      }
    }
    s_ord[r] = s;
  }
  __syncthreads();
  if (warp == 0) {
    // the split: the fewest stages k a split whose items all fit one
    // wave of the grid (and the scratch); none fit: no split
    const int cap = min((int)gridDim.x, p.part_items);
    int lo = 1, hi = cdiv(p.MB * p.BS, BN);
    if (all_items(p, s_ql, s_ctx, hi) > cap) lo = hi;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (all_items(p, s_ql, s_ctx, mid) <= cap) hi = mid;
      else lo = mid + 1;
    }
    const int k = lo;
    if (lane == 0) *s_k = k;
    int run = 0;
    if (lane == 0) s_pre[0] = 0;
    for (int r0 = 0; r0 < p.S; r0 += 32) {
      const int r = r0 + lane;
      int n = 0;
      if (r < p.S) {
        const int s = s_ord[r];
        n = slot_items(p, s_ql[s], s_ctx[s], k);
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, n, off);
        if (lane >= off) n += v;
      }
      if (r < p.S) s_pre[r + 1] = run + n;
      run += __shfl_sync(FULL_MASK, n, 31);
    }
  }
  __syncthreads();
  const int total = s_pre[p.S], k_split = *s_k;
  const int G = gridDim.x, b = blockIdx.x;
  auto item_index = [&](int k) {   // the snake: b, 2G - 1 - b, 2G + b, ..
    return k * G + ((k & 1) ? G - 1 - b : b);
  };

  if (warp == 4) {
    // ------------------------------------------------------ producer
    const int per = BN / p.BS;   // pages a stage
    if (lane == 0) {
      prefetch_tmap(&tk);
      prefetch_tmap(&tv);
    }
    int it = 0;
    for (int k = 0;; ++k) {
      const int i = item_index(k);
      if (i >= total) break;
      const Item w = item_of(p, i, s_pre, s_ord, s_ql, s_ctx, k_split);
      const int* trow = p.tables + (size_t)w.s * p.MB;
      const int live = cdiv(w.hi, p.BS);   // pages holding positions < hi
      for (int st = 0; st < w.nst; ++st, ++it) {
        const int slot = it % STAGES;
        mbar_wait(empty + slot, ((it / STAGES) & 1) ^ 1);
        const int j = (w.lo + st * BN) / p.BS + lane;
        const int page = lane < per && j < live ? trow[j] : p.NB;
        unsigned char* stage = ring + slot * C::STAGE_BYTES;
        if constexpr (POOL == INT8) {
          // the scales of the stage's positions lane and lane + 32, K's
          // and V's (zeros on a page past the item's last position)
          float* sc = reinterpret_cast<float*>(stage + 2 * C::KV_BYTES);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = lane + 32 * h;
            const int pg = __shfl_sync(FULL_MASK, page, c / p.BS);
            const bool ok = pg < p.NB;
            const size_t at =
                ok ? ((size_t)pg * p.BS + c % p.BS) * p.Hkv + w.g : 0;
            cp_async4(sc + c, p.kscale + at, ok);
            cp_async4(sc + BN + c, p.vscale + at, ok);
          }
          cp_async_mbar_arrive(full + slot);
        }
        if (lane == 0) mbar_expect_tx(full + slot, C::TX_BYTES);
        __syncwarp();
        if (lane < per) {
          if constexpr (POOL != BF16) {   // a page's rows, K's and V's
            tma_load_4d(stage + lane * p.BS * D * C::ES, &tk, full + slot, 0,
                        w.g, 0, page);
            tma_load_4d(stage + C::KV_BYTES + lane * p.BS * D * C::ES, &tv,
                        full + slot, 0, w.g, 0, page);
          } else {
            unsigned char* kd = stage + lane * p.BS * 128;
#pragma unroll
            for (int a = 0; a < NA; ++a) {
              tma_load_4d(kd + a * ATOM_BYTES, &tk, full + slot, a * 64, w.g,
                          0, page);
              tma_load_4d(kd + (NA + a) * ATOM_BYTES, &tv, full + slot,
                          a * 64, w.g, 0, page);
            }
          }
        }
      }
    }
  } else {
    // -------------------------------------------------------- consumers
    const int tig = lane % 4;
    const int v0 = 16 * warp + lane / 4;   // this thread's vectors v0, v0 + 8
    int it = 0;
    for (int k = 0;; ++k) {
      const int i = item_index(k);
      if (i >= total) break;
      const Item w = item_of(p, i, s_pre, s_ord, s_ql, s_ctx, k_split);
      const int nq = w.nrows * p.rep;
      const int mbs = p.MB * p.BS;
      // the tile's Q into shared memory (swizzled as TMA would put it;
      // dead vectors zero), once the last item's products are done
      bar_sync(1, 128);
      for (int c = tid; c < MQ * D / 8; c += 128) {
        const int v = c / (D / 8), cc = c % (D / 8);
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (v < nq) {
          const size_t vec = (size_t)(w.row0 + w.t0 + v / p.rep) * p.H +
                             w.g * p.rep + v % p.rep;
          x = *reinterpret_cast<const uint4*>(p.q + vec * D + cc * 8);
        }
        *reinterpret_cast<uint4*>(qs + (cc / 8) * ATOM_BYTES + v * 128 +
                                  (((cc % 8) ^ (v % 8)) * 16)) = x;
      }
      // the item's tree rows: a tree slot's first p.tree rows (none when
      // the slot is not flagged)
      const int trows =
          TREE && (p.tslots == nullptr || p.tslots[w.s] > 0) ? p.tree : 0;
      if (TREE && tid == 0) *s_titem = trows > w.t0;
      if (tid < MQ) {   // vector tid's mask (dead vectors see nothing)
        const int t = w.t0 + tid / p.rep;
        int lo = 0;
        uint32_t anc = 0u;
        if (tid < nq && t < trows) {
          lo = min(w.ctx, mbs);
          anc = s_tree[t & (MAX_TREE - 1)];
          if (mbs - lo < 32) anc &= (1u << (mbs - lo)) - 1u;
        } else if (tid < nq) {
          lo = min(w.ctx + t, mbs);
        }
        s_lo[tid] = lo;
        s_anc[tid] = anc;
      }
      fence_proxy_async();
      bar_sync(1, 128);
      // masked from the tile's first row's bound on; a tree's from ctx on
      const int bmin = min(TREE && *s_titem ? w.ctx : w.ctx + w.t0, mbs);
      float acc[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
      for (int st = 0; st < w.nst; ++st, ++it) {
        const int slot = it % STAGES;
        unsigned char* stage = ring + slot * C::STAGE_BYTES;
        const unsigned char* ks = POOL == INT8 ? conv : stage;
        const unsigned char* vs = ks + C::V_TILE;
        mbar_wait(full + slot, (it / STAGES) & 1);
        if constexpr (POOL == F32) {
          // the stage's floats into its hi / lo tiles, published to the
          // tensor cores
          convert_f32_stage<D>(stage, warp, lane);
          fence_proxy_async();
          bar_sync(1, 128);
        }
        if constexpr (POOL == INT8) {
          // once the last stage's products are done with the tile: the
          // stage converted into it, the stage freed, the tile published
          // to the tensor cores
          bar_sync(1, 128);
          convert_stage<D>(stage, conv, tid);
          warp_arrive(empty + slot);
          fence_proxy_async();
          bar_sync(1, 128);
        }
        float sc[BN / 2];
        wgmma_fence();
        // S = Q K^T; f32: Q K_hi^T + Q K_lo^T
#pragma unroll
        for (int h = 0; h < (POOL == F32 ? 2 : 1); ++h)
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(sc,
                     desc_sw128(qs + (kk / 4) * ATOM_BYTES + (kk % 4) * 32, 0,
                                1024),
                     desc_sw128(ks + h * C::LO + (kk / 4) * C::ATOM_STEP +
                                    (kk % 4) * 32,
                                0, C::GROUP),
                     h > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        // the online softmax of the stage's 64 columns (log2 domain)
        const int c0 = w.lo + st * BN;
        const bool edge = c0 + BN > bmin;
        // int8: this thread's columns' K scales times the softmax scale
        float kmul[BN / 8][2];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          if constexpr (POOL == INT8) {
            const float2 k2 =
                *reinterpret_cast<const float2*>(csc + 8 * j + 2 * tig);
            kmul[j][0] = k2.x * p.scale_log2;
            kmul[j][1] = k2.y * p.scale_log2;
          } else {
            kmul[j][0] = kmul[j][1] = p.scale_log2;
          }
        }
        float alpha[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          // three uniform paths: a tree's edge stage, a linear edge stage,
          // a stage every column of which is visible
          float mx = NEG_INF;
          const int lo = s_lo[v0 + 8 * hr];
          if (TREE && edge && *s_titem) {
            const uint32_t anc = s_anc[v0 + 8 * hr];
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& x = sc[4 * j + 2 * hr + e];
                const int rel = c0 + 8 * j + 2 * tig + e - lo;
                x = rel < 0 || (rel < 32 && ((anc >> (rel & 31)) & 1u))
                        ? x * kmul[j][e]
                        : NEG_INF;
                mx = fmaxf(mx, x);
              }
          } else if (edge) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& x = sc[4 * j + 2 * hr + e];
                x = c0 + 8 * j + 2 * tig + e < lo ? x * kmul[j][e] : NEG_INF;
                mx = fmaxf(mx, x);
              }
          } else {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& x = sc[4 * j + 2 * hr + e];
                x *= kmul[j][e];
                mx = fmaxf(mx, x);
              }
          }
          const float m_new = fmaxf(m[hr], fa::quad_max(mx));
          alpha[hr] = fa::ex2(m[hr] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sc[4 * j + 2 * hr + e];
              x = x == NEG_INF ? 0.f : fa::ex2(x - m_new);
              sum += x;
            }
          l[hr] = alpha[hr] * l[hr] + sum;
          m[hr] = m_new;
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];
        if constexpr (POOL == INT8) {   // P' = P x V's scale of the column
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float2 v2 =
                *reinterpret_cast<const float2*>(csc + BN + 8 * j + 2 * tig);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              sc[4 * j + 2 * hr] *= v2.x;
              sc[4 * j + 2 * hr + 1] *= v2.y;
            }
          }
        }
        uint32_t pa[BN / 16][4];   // P as bf16 A fragments
        fa::pack_a(pa, sc);
        constexpr bool SPLIT = POOL == F32 || (POOL == INT8 && P_SPLIT);
        uint32_t pl[SPLIT ? BN / 16 : 1][4];   // P' - bf16(P')
        if constexpr (SPLIT) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            sc[i] -= __bfloat162float(__float2bfloat16_rn(sc[i]));
          fa::pack_a(pl, sc);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const unsigned char* v16 = vs + kk * 2 * C::GROUP;   // 16 rows
          wgmma_rs_tb(acc, pa[kk],
                      desc_sw128(v16, C::ATOM_STEP, C::GROUP));
          if constexpr (SPLIT)
            wgmma_rs_tb(acc, pl[kk],
                        desc_sw128(v16, C::ATOM_STEP, C::GROUP));
          if constexpr (POOL == F32)   // + P_hi V_lo
            wgmma_rs_tb(acc, pa[kk],
                        desc_sw128(v16 + C::LO, C::ATOM_STEP, C::GROUP));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if constexpr (POOL != INT8) warp_arrive(empty + slot);
      }
      float lt[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) lt[hr] = fa::quad_sum(l[hr]);
      if (w.ns == 1) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int v = v0 + 8 * hr;
          if (v >= nq) continue;
          const float mul = lt[hr] == 0.f ? 1.f : 1.f / lt[hr];
          bf16* dst = p.out +
                      ((size_t)(w.row0 + w.t0 + v / p.rep) * p.H +
                       w.g * p.rep + v % p.rep) * D +
                      2 * tig;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j + 2 * hr] * mul,
                                      acc[4 * j + 2 * hr + 1] * mul);
        }
        continue;
      }
      // a split: its partial, then the arrival; the last merges
      // split j's partial: the record of item first + j * Hkv + g
      const size_t per_split = (size_t)p.Hkv * p.NV;
      const size_t tile0 = ((size_t)w.first + w.g) * p.NV;
      float* part_m = p.part + (size_t)p.part_items * p.NV * D;
      float* part_l = part_m + (size_t)p.part_items * p.NV;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int v = v0 + 8 * hr;
        if (v >= nq) continue;
        const size_t pv = w.split * per_split + tile0 + v;
        float* dst = p.part + pv * D + 2 * tig;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
        if (tig == 0) {
          part_m[pv] = m[hr];
          part_l[pv] = lt[hr];
        }
      }
      __threadfence();
      bar_sync(1, 128);
      if (tid == 0) {
        int* cnt = p.counters + (size_t)w.s * p.Hkv + w.g;
        const bool last = atomicAdd(cnt, 1) == w.ns - 1;
        if (last) *cnt = 0;
        *s_last = last;
      }
      bar_sync(1, 128);
      if (!*s_last) continue;
      __threadfence();
      // the last split merges every split's partial, its own too, in
      // split order (two calls give the same bits): a thread a (vector,
      // 4 columns), four splits' loads in flight
      constexpr int CH = D / 4;
      for (int u = tid; u < nq * CH; u += 128) {
        const int v = u / CH, c = u % CH;
        float mx = NEG_INF, sum = 0.f;
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int j = 0; j < w.ns; ++j) {
          const size_t pv = j * per_split + tile0 + v;
          const float mj = __ldcg(part_m + pv), lj = __ldcg(part_l + pv);
          const float4 x =
              __ldcg(reinterpret_cast<const float4*>(p.part + pv * D) + c);
          const float m_new = fmaxf(mx, mj);
          const float a = fa::ex2(mx - m_new), bj = fa::ex2(mj - m_new);
          sum = sum * a + bj * lj;
          o.x = o.x * a + bj * x.x;
          o.y = o.y * a + bj * x.y;
          o.z = o.z * a + bj * x.z;
          o.w = o.w * a + bj * x.w;
          mx = m_new;
        }
        const float mul = sum == 0.f ? 1.f : 1.f / sum;
        bf16* dst = p.out +
                    ((size_t)(w.row0 + w.t0 + v / p.rep) * p.H +
                     w.g * p.rep + v % p.rep) * D + 4 * c;
        uint2 pk;
        pk.x = fa::pack_bf16(o.x * mul, o.y * mul);
        pk.y = fa::pack_bf16(o.z * mul, o.w * mul);
        *reinterpret_cast<uint2*>(dst) = pk;
      }
    }
  }
}

// ---------------------------------------------------------------- launch

// the current device (dev) and its SMs, asked of the runtime once a device
inline int sm_count(int& dev) {
  static int sms[64] = {};
  dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 1;
  if (dev < 64 && sms[dev] > 0) return sms[dev];
  int n = 1;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 1;
  if (dev < 64) sms[dev] = n;
  return n;
}

// the 4-D map of a pool [NB, BS, Hkv, D] (dims D, Hkv, BS, NB), through a
// direct-mapped cache keyed by address, shape and element type (a model
// has a pool pair a layer, and the pools stay put from tick to tick; an
// int8 or float32 pool may take the address another pool of its shape
// once had). es, the bytes an element: 2 (bf16): box 64 columns x 1 head
// x BS rows x 1 page, 128-byte swizzle; 1 (int8) or 4 (float32): box D
// columns x 1 x BS x 1, rows as they lie.
inline cudaError_t pool_map(CUtensorMap* map, const void* pool, int NB,
                            int BS, int Hkv, int D, int es) {
  struct Entry {
    const void* base;
    int NB, BS, Hkv, D, es;
    CUtensorMap map;
  };
  static Entry cache[1024];
  static std::mutex lock;
  const size_t slot = (reinterpret_cast<uintptr_t>(pool) >> 8) % 1024;
  std::lock_guard<std::mutex> hold(lock);
  Entry& e = cache[slot];
  if (e.base != pool || e.NB != NB || e.BS != BS || e.Hkv != Hkv ||
      e.D != D || e.es != es) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv,
                                (cuuint64_t)BS, (cuuint64_t)NB};
    const cuuint64_t strides[3] = {(cuuint64_t)D * es,
                                   (cuuint64_t)Hkv * D * es,
                                   (cuuint64_t)BS * Hkv * D * es};
    const cuuint32_t box[4] = {es == 2 ? 64u : (cuuint32_t)D, 1,
                               (cuuint32_t)BS, 1};
    const cudaError_t err =
        es == 2 ? sm90::tmap_bf16(&e.map, pool, 4, dims, strides, box)
                : sm90::tmap_encode(&e.map,
                                    es == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                    CU_TENSOR_MAP_SWIZZLE_NONE, pool, 4, dims,
                                    strides, box);
    if (err != cudaSuccess) {
      e.base = nullptr;
      return err;
    }
    e.base = pool;
    e.NB = NB;
    e.BS = BS;
    e.Hkv = Hkv;
    e.D = D;
    e.es = es;
  }
  *map = e.map;
  return cudaSuccess;
}

template <int D, int POOL, bool TREE>
cudaError_t launch_d(const void* kp, const void* vp, const Params& p,
                     cudaStream_t stream) {
  using C = Cfg<D, POOL>;
  CUtensorMap tk, tv;
  cudaError_t err = pool_map(&tk, kp, p.NB, p.BS, p.Hkv, D, C::ES);
  if (err == cudaSuccess)
    err = pool_map(&tv, vp, p.NB, p.BS, p.Hkv, D, C::ES);
  if (err != cudaSuccess) return err;
  int dev;
  const int sms = sm_count(dev);
  static unsigned long long ready = 0;   // the attribute set, a bit a device
  if (dev >= 64 || !(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(paged_attention_kernel<D, POOL, TREE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready |= 1ull << dev;
  }
  // a wave of blocks, fewer if the call cannot have that many items (a
  // slot has at most a stage's items a kv head, or its tiles)
  const long most =
      (long)p.S * p.Hkv *
      std::max(cdiv(p.MB * p.BS, BN), cdiv(p.w_max, p.TQ));
  const int grid = (int)std::min<long>(most, (long)C::BLOCKS * sms);
  paged_attention_kernel<D, POOL, TREE>
      <<<grid, THREADS, C::SMEM, stream>>>(tk, tv, p);
  return cudaGetLastError();
}

template <int POOL>
cudaError_t launch_pool(const void* kp, const void* vp, const Params& p,
                        int D, cudaStream_t stream) {
  return p.tree ? (D == 64 ? launch_d<64, POOL, true>(kp, vp, p, stream)
                           : launch_d<128, POOL, true>(kp, vp, p, stream))
                : (D == 64 ? launch_d<64, POOL, false>(kp, vp, p, stream)
                           : launch_d<128, POOL, false>(kp, vp, p, stream));
}

// the blocks an SM of the instance for pool kind `pool` at head dim D
// (its grid is a wave of them), or 0 for a kind or D it does not take
inline int blocks_per_sm(int pool, int D) {
  if (D != 64 && D != 128) return 0;
  switch (pool) {
    case BF16: return D == 64 ? Cfg<64, BF16>::BLOCKS : Cfg<128, BF16>::BLOCKS;
    case INT8: return D == 64 ? Cfg<64, INT8>::BLOCKS : Cfg<128, INT8>::BLOCKS;
    case F32: return D == 64 ? Cfg<64, F32>::BLOCKS : Cfg<128, F32>::BLOCKS;
  }
  return 0;
}

// the body for bf16 q / out over bf16 pools, int8 pools (kp / vp int8
// data, ks / vs their float32 scales [NB, BS, Hkv]; both null otherwise)
// or, with f32, float32 pools: checks what it takes and launches (w_max
// rows a slot at most; part holds part_items x NV x (D + 2) floats, NV =
// min(TQ, w_max) x rep: splits are taken only while every item has a
// record, and a wave of the grid, blocks_per_sm x SMs blocks, needs no
// more). tree_bits (host, tree_t <= 32 words, or null): the tree mode,
// row t < tree_t of a tree slot masked by tree_bits[t]; tree_t 0 means
// w_max (K2v: every row of a window), and the tree slots are those of
// tree_slots[s] > 0 (device [S]; null: every slot). K2v's windows (qlens
// null) must fit the tree.
inline cudaError_t launch(const void* q, const void* kp, const void* vp,
                          const float* ks, const float* vs, bool f32,
                          const int* tables, const int* ctx,
                          const int* qlens, const int* starts, void* out,
                          float* part, int* counters, int S, int H, int Hkv,
                          int D, int BS, int MB, int NB, int w_max,
                          int part_items, float scale, cudaStream_t stream,
                          const uint32_t* tree_bits = nullptr,
                          int tree_t = 0,
                          const int* tree_slots = nullptr) {
  if (tree_bits != nullptr && tree_t == 0) tree_t = w_max;
  if (S < 1 || S > MAX_SLOTS || Hkv < 1 || H % Hkv != 0 ||
      (tree_bits != nullptr &&
       (tree_t < 1 || tree_t > MAX_TREE ||
        (qlens == nullptr && w_max > tree_t))) ||
      H / Hkv > MQ || (BS != 8 && BS != 16 && BS != 32) || MB < 1 ||
      NB < 1 || w_max < 1 || part_items < 0 ||
      (part_items > 0 && (part == nullptr || counters == nullptr)) ||
      (D != 64 && D != 128) || (ks == nullptr) != (vs == nullptr) ||
      (f32 && ks != nullptr))
    return cudaErrorInvalidValue;
  Params p;
  p.q = (const bf16*)q;
  p.out = (bf16*)out;
  p.kscale = ks;
  p.vscale = vs;
  p.tables = tables;
  p.ctx = ctx;
  p.qlens = qlens;
  p.starts = starts;
  p.part = part;
  p.counters = counters;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.rep = H / Hkv;
  p.BS = BS;
  p.MB = MB;
  p.NB = NB;
  p.w_max = w_max;
  p.TQ = MQ / p.rep;
  p.NV = std::min(p.TQ, w_max) * p.rep;
  p.part_items = part_items;
  p.scale_log2 = scale * fa::LOG2E;
  p.tree = tree_bits != nullptr ? tree_t : 0;
  for (int t = 0; t < MAX_TREE; ++t)
    p.tree_bits[t] = t < p.tree ? tree_bits[t] : 0u;
  p.tslots = tree_bits != nullptr ? tree_slots : nullptr;
  if (f32) return launch_pool<F32>(kp, vp, p, D, stream);
  if (ks != nullptr) return launch_pool<INT8>(kp, vp, p, D, stream);
  return launch_pool<BF16>(kp, vp, p, D, stream);
}

}  // namespace
}  // namespace pa90
}  // namespace ptt
