// K2r: ragged paged attention over one packed row buffer — the decode
// rows, prefill-chunk rows (and later verify windows) of every slot of
// a serving tick, attended against each slot's blocks of the paged KV
// pool in one call.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py, _ragged_kernel
// (via pallas_ragged_paged_attention, :593): floating pools and int8 pools
// (the `quantized` mode: int8 K/V pages and a float32 scale a position and
// kv head, dequantized as they are read), linear or with the per-slot
// token-tree mask (tree_bits + tree_ref, :339-355; the entry
// ptt_ragged_paged_attention_tree): row t < T of a slot flagged in
// tree_slots keeps the columns below lens[s] and, of the window, its
// ancestors (bit c - lens[s] of its mask); other rows and slots keep the
// linear bound. The mask is a subset of the linear bound, so the blocks a
// tile reads and its splits are the linear ones.
//
// A bfloat16 q runs the Hopper body of paged_attention_sm90.cuh (wgmma
// over a TMA page ring, the split merge in the same launch) over bfloat16,
// int8 or float32 pools (dtype code 2: GPT's pools stay float32 under a
// bfloat16 model; float32 pages as bf16 hi + lo halves); a float32 q runs
// the CUDA-core body below.
//
// What bounds it on the H100: bytes. Each live K/V block of a slot is
// read once per kv head, and per read block a row does 4 * D flops per
// position, far below the card's ~295 flops per byte; the least time is
// (live K/V bytes + q + out) / 3.35 TB/s.
//
// float32 design: one thread block per (slot, kv head, tile of <= 16
// window rows of that slot, split of the slot's context). A block whose
// tile starts at or past q_lens[s], or whose split starts past the
// tile's last visible block, returns at once; the others read their own
// q_lens, row_starts, context_lens and block-table row. The block takes
// the tile's rows x the rep query heads of its kv group together (<= 64
// query vectors, staged in shared memory), so each K/V block is read
// once per kv group and split, as the TPU grid does. It walks its
// split's blocks j (while j * BS < lens[s] + t_last), 32 / BS blocks a
// step, staging their 32 columns of K and V in shared memory with
// 16-byte loads (rows padded by one float so the per-column dot products
// hit distinct banks). Each warp owns every fourth query vector and
// keeps its online-softmax state (m, l and a D/32-wide slice of acc per
// lane) in float32 registers: lane c scores column c of the step, the
// warp reduces max and sum, and every lane accumulates its slice of
// P @ V. Row t of slot s sees
// columns < lens[s] + t. With one split the block finishes with
// acc / (l == 0 ? 1 : l), as the TPU kernel's _finish does. Long
// contexts are cut into n_split ranges of blocks (the caller picks
// n_split from the table's reach) so a decode row's context is read by
// many blocks at once (the TPU walks it in one grid row; here that would
// leave most SMs idle); each split then writes its unnormalised
// (m, l, acc) to scratch and a second kernel merges the splits with the
// same online-softmax rescaling (one warp per query vector, a lane per
// split's (m, l), so no warp walks vectors or splits one by one).
//
// Shapes: q and out [R, H, D]; pools [NB, BS, Hkv, D]; tables [S, MB],
// context_lens / q_lens / row_starts [S] int32; H = rep * Hkv with
// rep <= 64; D in {64, 128}; BS in {8, 16, 32}; float32 or bfloat16
// (bfloat16: S <= 512); pools of q's dtype, float32 pools under a
// bfloat16 q (dtype 2, the Hopper body), or int8 with scales
// [NB, BS, Hkv] (float32 q: this body reads each 4 int8 values with their
// scale and stages them in float32, the reference's recipe; bfloat16 q:
// the Hopper body's int8 mode). Rows outside every slot's [row_starts,
// row_starts + q_lens) are not written. Scratch (float32, from the
// caller): float32 n_split * R * H * (D + 2), n_split <= 32; bfloat16
// (and dtype 2) below.
#include "common.cuh"
#include "paged_attention_sm90.cuh"

namespace {

using namespace ptt;

constexpr int NW = 4;         // warps per block
constexpr int MAX_Q = 64;     // query vectors per block
constexpr int QW = MAX_Q / NW;
constexpr int MAX_BS = 32;    // columns staged a step: 32 / BS blocks
constexpr int MERGE_GROUPS = MAX_Q / NW;
constexpr int MAX_SPLITS = 32;  // one lane of the merge per split
constexpr float MASKED = -1e30f;

// where a query vector of the tile lives in q / out / scratch
__device__ __forceinline__ size_t qv_offset(int row0, int t0, int qv,
                                            int rep, int g, int H) {
  const int t = t0 + qv / rep, ri = qv % rep;
  return (size_t)(row0 + t) * H + g * rep + ri;   // in units of vectors
}

template <typename T, typename KV, int D, bool TREE>
__global__ void __launch_bounds__(NW * 32)
    ragged_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                  const KV* __restrict__ vp, const float* __restrict__ ks,
                  const float* __restrict__ vs,
                  const int* __restrict__ tables,
                  const int* __restrict__ ctx_lens,
                  const int* __restrict__ qlens,
                  const int* __restrict__ starts, T* __restrict__ out,
                  float* __restrict__ part, int R, int H, int Hkv, int BS,
                  int MB, int rep, int TQ, int n_split, float scale,
                  const int* __restrict__ tslots, int tree_t,
                  const __grid_constant__ TreeBits tree) {
  constexpr int DL = D / 32;
  constexpr int DP = D + 1;
  constexpr int VEC = 16 / sizeof(T);
  static_assert(VEC == 4, "the float32 body: 4 elements a chunk (Kv4)");
  const int s = blockIdx.x, g = blockIdx.y;
  const int tile = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int ql = qlens[s];
  const int t0 = tile * TQ;
  if (t0 >= ql) return;
  const int t1 = min(t0 + TQ, ql);
  const int lens = ctx_lens[s];
  // the tile's last row sees lens + t1 - 1 columns
  const int nblk = min((lens + t1 - 1 + BS - 1) / BS, MB);
  const int per = (nblk + n_split - 1) / n_split;
  const int j0 = split * per, j1 = min(j0 + per, nblk);
  if (j0 >= j1 && split > 0) return;
  const int nq = (t1 - t0) * rep;
  const int row0 = starts[s];
  const int* trow = tables + (size_t)s * MB;
  // the slot's tree rows (TREE: its first tree_t when it is flagged)
  const int trows = TREE && (tslots == nullptr || tslots[s] > 0) ? tree_t : 0;

  extern __shared__ float smem[];
  float* q_s = smem;                 // [MAX_Q][D]
  float* k_s = q_s + MAX_Q * D;      // [MAX_BS][D + 1]
  float* v_s = k_s + MAX_BS * DP;    // [MAX_BS][D + 1]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < nq * (D / VEC); i += NW * 32) {
    const int qv = i / (D / VEC), dd = (i % (D / VEC)) * VEC;
    load_vec<T>(q + qv_offset(row0, t0, qv, rep, g, H) * D + dd,
                q_s + qv * D + dd);
  }

  float m[QW], l[QW], acc[QW][DL];
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    m[qi] = MASKED;
    l[qi] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[qi][e] = 0.f;
  }

  // JB blocks a step, so the 32 lanes score 32 columns (BS = 8, 16, 32)
  const int JB = 32 / BS;
  for (int j = j0; j < j1; j += JB) {
    const int ncols = min(JB, j1 - j) * BS;  // columns staged this step
    __syncthreads();  // q staged / previous K-V tile consumed
    for (int i = tid; i < ncols * (D / VEC); i += NW * 32) {
      const int c = i / (D / VEC), dd = (i % (D / VEC)) * VEC;
      const size_t b = (size_t)trow[j + c / BS];
      const size_t row = (b * BS + c % BS) * Hkv + g;   // scale row
      Kv4<KV> kr, vr;
      kr.load(kp + row * D + dd, ks, row);
      vr.load(vp + row * D + dd, vs, row);
      float kv[VEC], vv[VEC];
      kr.to_f(kv);
      vr.to_f(vv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[c * DP + dd + e] = kv[e];
        v_s[c * DP + dd + e] = vv[e];
      }
    }
    __syncthreads();
    const int col = j * BS + lane;
    // only a step that reaches past lens holds window columns, where a
    // tree row's mask applies
    const int srows = j * BS + ncols > lens ? trows : 0;
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const int qv = warp + qi * NW;
      if (qv < nq) {  // uniform across the warp
        const int t = t0 + qv / rep;
        // a tree row: the prefix, then its ancestors (all ones: linear)
        const uint32_t anc = t < srows ? tree.bits[t] : ~0u;
        const int rel = col - lens;
        const bool live = lane < ncols && col < lens + t &&
                          (rel < 0 || (anc >> (rel & 31)) & 1u);
        float sc = MASKED;
        if (live) {
          const float* qr = q_s + qv * D;
          const float* kr = k_s + lane * DP;
          float dot = 0.f;
#pragma unroll 16
          for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
          sc = dot * scale;
        }
        const float m_new = fmaxf(m[qi], warp_max(sc));
        const float p = live ? expf(sc - m_new) : 0.f;
        const float alpha = expf(m[qi] - m_new);
        l[qi] = alpha * l[qi] + warp_sum(p);
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[qi][e] *= alpha;
        for (int c = 0; c < ncols; ++c) {
          const float pc = __shfl_sync(FULL_MASK, p, c);
#pragma unroll
          for (int e = 0; e < DL; ++e)
            acc[qi][e] = fmaf(pc, v_s[c * DP + lane + 32 * e], acc[qi][e]);
        }
        m[qi] = m_new;
      }
    }
  }

  // one split: normalise and store; several: store the partial state
  const size_t RH = (size_t)R * H;
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    const int qv = warp + qi * NW;
    if (qv < nq) {
      const size_t v = qv_offset(row0, t0, qv, rep, g, H);
      if (n_split == 1) {
        const float inv = 1.f / (l[qi] == 0.f ? 1.f : l[qi]);
        T* o = out + v * D;
#pragma unroll
        for (int e = 0; e < DL; ++e)
          o[lane + 32 * e] = from_f<T>(acc[qi][e] * inv);
      } else {
        float* pa = part + ((size_t)split * RH + v) * D;
#pragma unroll
        for (int e = 0; e < DL; ++e) pa[lane + 32 * e] = acc[qi][e];
        if (lane == 0) {
          float* pm = part + (size_t)n_split * RH * D;
          pm[(size_t)split * RH + v] = m[qi];
          pm[(size_t)n_split * RH + (size_t)split * RH + v] = l[qi];
        }
      }
    }
  }
}

// merge the splits of each query vector: one warp per vector, lane sp
// reading split sp's (m, l), MERGE_GROUPS blocks of NW vectors per tile
template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
    merge_kernel(const int* __restrict__ ctx_lens,
                 const int* __restrict__ qlens,
                 const int* __restrict__ starts,
                 const float* __restrict__ part,
                 T* __restrict__ out, int R, int H, int BS, int MB, int rep,
                 int TQ, int n_split) {
  constexpr int DL = D / 32;
  const int s = blockIdx.x, g = blockIdx.y;
  const int tile = blockIdx.z / MERGE_GROUPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qv = (blockIdx.z % MERGE_GROUPS) * NW + warp;
  const int ql = qlens[s];
  const int t0 = tile * TQ;
  if (t0 >= ql) return;
  const int t1 = min(t0 + TQ, ql);
  if (qv >= (t1 - t0) * rep) return;  // uniform across the warp
  const int nblk = min((ctx_lens[s] + t1 - 1 + BS - 1) / BS, MB);
  const int per = (nblk + n_split - 1) / n_split;
  const int used = (nblk + per - 1) / per;     // splits that ran
  const size_t RH = (size_t)R * H;
  const float* pm = part + (size_t)n_split * RH * D;
  const float* pl = pm + (size_t)n_split * RH;
  const size_t v = qv_offset(starts[s], t0, qv, rep, g, H);
  const bool mine = lane < used;
  const float ms = mine ? pm[(size_t)lane * RH + v] : MASKED;
  const float ls = mine ? pl[(size_t)lane * RH + v] : 0.f;
  const float mx = warp_max(ms);
  const float w = mine ? expf(ms - mx) : 0.f;
  const float l = warp_sum(w * ls);
  float acc[DL];
#pragma unroll
  for (int e = 0; e < DL; ++e) acc[e] = 0.f;
  for (int sp = 0; sp < used; ++sp) {
    const float ws = __shfl_sync(FULL_MASK, w, sp);
    const float* pa = part + ((size_t)sp * RH + v) * D;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[e] = fmaf(ws, pa[lane + 32 * e], acc[e]);
  }
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* o = out + v * D;
#pragma unroll
  for (int e = 0; e < DL; ++e) o[lane + 32 * e] = from_f<T>(acc[e] * inv);
}

template <typename T, typename KV, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs,
                   const int* tables, const int* ctx, const int* qlens,
                   const int* starts, void* out, float* part, int R, int S,
                   int H, int Hkv, int BS, int MB, int w_max, int n_split,
                   float scale, cudaStream_t stream,
                   const uint32_t* tree_bits, int tree_t,
                   const int* tree_slots) {
  const int rep = H / Hkv;
  const int TQ = max(1, min(16, MAX_Q / rep));
  const int n_tiles = (w_max + TQ - 1) / TQ;
  dim3 grid(S, Hkv, n_tiles * n_split);
  const size_t smem = sizeof(float) * (MAX_Q * D + 2 * MAX_BS * (D + 1));
  TreeBits tree = {};
  for (int t = 0; tree_bits != nullptr && t < tree_t; ++t)
    tree.bits[t] = tree_bits[t];
  auto kernel = tree_bits != nullptr ? &ragged_kernel<T, KV, D, true>
                                     : &ragged_kernel<T, KV, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NW * 32, smem, stream>>>(
      (const T*)q, (const KV*)kp, (const KV*)vp, ks, vs, tables, ctx, qlens,
      starts,
      (T*)out, part, R, H, Hkv, BS, MB, rep, TQ, n_split, scale, tree_slots,
      tree_bits != nullptr ? tree_t : 0, tree);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  merge_kernel<T, D>
      <<<dim3(S, Hkv, n_tiles * MERGE_GROUPS), NW * 32, 0, stream>>>(
      ctx, qlens, starts, part, (T*)out, R, H, BS, MB, rep, TQ, n_split);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp,
                       const float* ks, const float* vs, const int* tables,
                       const int* ctx, const int* qlens, const int* starts,
                       void* out, float* part, int R, int S, int H, int Hkv,
                       int D, int BS, int MB, int w_max, int n_split,
                       float scale, cudaStream_t stream,
                       const uint32_t* tree_bits, int tree_t,
                       const int* tree_slots) {
  if (D == 64)
    return launch<T, KV, 64>(q, kp, vp, ks, vs, tables, ctx, qlens, starts,
                             out, part, R, S, H, Hkv, BS, MB, w_max, n_split,
                             scale, stream, tree_bits, tree_t, tree_slots);
  if (D == 128)
    return launch<T, KV, 128>(q, kp, vp, ks, vs, tables, ctx, qlens, starts,
                              out, part, R, S, H, Hkv, BS, MB, w_max,
                              n_split, scale, stream, tree_bits, tree_t,
                              tree_slots);
  return cudaErrorInvalidValue;
}

int run(const void* q, const void* kp, const void* vp, const void* ks,
        const void* vs, const void* tables, const void* ctx,
        const void* qlens, const void* starts, void* out, void* part,
        void* counters, int R, int S, int H, int Hkv, int D, int BS, int MB,
        int NB, int w_max, int n_split, float scale, int dtype, void* stream,
        const uint32_t* tree_bits, int tree_t, const int* tree_slots) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  const int* cl = (const int*)ctx;
  const int* qls = (const int*)qlens;
  const int* rs = (const int*)starts;
  float* pp = (float*)part;
  const float* ksf = (const float*)ks;
  const float* vsf = (const float*)vs;
  if ((ks == nullptr) != (vs == nullptr) ||
      (tree_bits != nullptr && (tree_t < 1 || tree_t > 32)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 || dtype == 2) {   // dtype 2: over float32 pools
    if (R < 1 || qls == nullptr || rs == nullptr)
      return (int)cudaErrorInvalidValue;
    return (int)pa90::launch(q, kp, vp, ksf, vsf, dtype == 2, tb, cl, qls,
                             rs, out, pp, (int*)counters, S, H, Hkv, D, BS,
                             MB, NB, w_max, n_split, scale, st, tree_bits,
                             tree_t, tree_slots);
  }
  if (dtype != 0 || S < 1 || R < 1 || Hkv < 1 || H % Hkv != 0 ||
      H / Hkv > MAX_Q || BS < 1 || BS > MAX_BS || MAX_BS % BS || w_max < 1 ||
      n_split < 1 || n_split > MAX_SPLITS ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (ks != nullptr)
    return (int)dispatch_d<float, int8_t>(q, kp, vp, ksf, vsf, tb, cl, qls,
                                          rs, out, pp, R, S, H, Hkv, D, BS,
                                          MB, w_max, n_split, scale, st,
                                          tree_bits, tree_t, tree_slots);
  return (int)dispatch_d<float, float>(q, kp, vp, nullptr, nullptr, tb, cl,
                                       qls, rs, out, pp, R, S, H, Hkv, D, BS,
                                       MB, w_max, n_split, scale, st,
                                       tree_bits, tree_t, tree_slots);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 bfloat16 q and out over float32 pools.
// kp / vp: pools of q's dtype (ks, vs null; float32 for dtype 2), or int8
// pools with their float32 scales ks / vs [NB, BS, Hkv] (dtype 0 or 1).
// float32: part is scratch of n_split * R * H * (D + 2) floats (unused
// and may be null when n_split == 1), counters unused. bfloat16 and dtype
// 2: n_split is the split records part holds, each NV * (D + 2) floats,
// NV = min(64 / rep, w_max) * rep (ptt_paged_attention_blocks_per_sm x
// SMs records take every split the body makes; 0: none), counters S *
// Hkv zeros, left zero.
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* tables,
    const void* ctx, const void* qlens, const void* starts, void* out,
    void* part, void* counters, int R, int S, int H, int Hkv, int D, int BS,
    int MB, int NB, int w_max, int n_split, float scale, int dtype,
    void* stream) {
  return run(q, kp, vp, ks, vs, tables, ctx, qlens, starts, out, part,
             counters, R, S, H, Hkv, D, BS, MB, NB, w_max, n_split, scale,
             dtype, stream, nullptr, 0, nullptr);
}

// the tree mode: as ptt_ragged_paged_attention, with row t < tree_t
// (1..32) of each slot s whose tree_slots[s] > 0 (device int32 [S]; null:
// every slot) masked by tree_bits[t] (host memory, tree_t words: row t's
// ancestors, bit j - 1 for window node j; tree_ancestor_bits of
// ops/kernels/paged_attention.py); the other rows keep the linear bound.
extern "C" int ptt_ragged_paged_attention_tree(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* tables,
    const void* ctx, const void* qlens, const void* starts, void* out,
    void* part, void* counters, int R, int S, int H, int Hkv, int D, int BS,
    int MB, int NB, int w_max, int n_split, float scale, int dtype,
    void* stream, const uint32_t* tree_bits, int tree_t,
    const void* tree_slots) {
  if (tree_bits == nullptr) return (int)cudaErrorInvalidValue;
  return run(q, kp, vp, ks, vs, tables, ctx, qlens, starts, out, part,
             counters, R, S, H, Hkv, D, BS, MB, NB, w_max, n_split, scale,
             dtype, stream, tree_bits, tree_t, (const int*)tree_slots);
}

// the Hopper body's blocks an SM (its grid is a wave of them) for dtype
// code `dtype` (1 over bfloat16 pools, or int8 pools with int8 != 0; 2)
// at head dim D; 0 where it takes no such call
extern "C" int ptt_paged_attention_blocks_per_sm(int dtype, int int8,
                                                 int D) {
  if (dtype == 2) return int8 ? 0 : pa90::blocks_per_sm(pa90::F32, D);
  if (dtype == 1)
    return pa90::blocks_per_sm(int8 ? pa90::INT8 : pa90::BF16, D);
  return 0;
}
