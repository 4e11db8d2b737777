// K2d / K2v: paged attention of generate()'s decode step (one query
// token per slot) and of the speculative verify window (T tokens per
// slot, causal within the window), over each slot's blocks of the paged
// KV pool.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py, _decode_kernel
// via pallas_paged_attention (K2d, t_q = 1) and via
// pallas_paged_verify_attention (K2v, t_q = T: the linear chain, and the
// token-tree mask of tree_bits, :255-270): floating pools and int8 pools
// (the `quantized` mode: int8 K/V pages and a float32 scale a position and
// kv head).
//
// A bfloat16 q runs the Hopper body of paged_attention_sm90.cuh (K2r's, a
// window of T rows a slot: wgmma over a TMA page ring, the split merge in
// the same launch) over bfloat16, int8 or float32 pools (dtype code 2:
// GPT's pools stay float32 under a bfloat16 model); a float32 q runs the
// CUDA-core body below.
//
// What bounds it on the H100: bytes. Each live K/V block of a slot is
// read once per kv head; per position a query vector does 4 * D flops,
// far below the card's ~295 flops per byte, so the least time is
// (live K/V bytes + q + out) / 3.35 TB/s.
//
// float32 design: two kernels, decode_kernel (K2d, the window of one token
// fixed at compile time) and verify_kernel (K2v), over one body; each has
// its own C entry point. One thread block per (slot, kv head, window tile,
// split of the slot's context). A tile is TR = 64 / rep consecutive window
// tokens (the whole window when it fits: a verify window; a prefill chunk
// of the per-width engine takes several); the block takes every query
// vector of its kv group in its tile -- its tokens x the rep query heads,
// <= 64, staged in shared memory from the [S, T, H, D] layout as it lies
// -- so each K/V block is read once per (group, tile), as the TPU grid
// reads it once per group. Decode has only S x Hkv such groups (64 at 8
// slots of Llama-3-8B, on 132 SMs), so the context is cut into n_split
// ranges of blocks (the caller picks n_split to put about 8 blocks on each
// SM); each split writes its unnormalised (m, l, acc) to scratch and a
// second kernel merges the splits with the online-softmax rescale (one warp
// per query vector, a lane per split). Within a split the block walks blocks
// j while j * BS < lens + t1 - 1 (t1 the end of its tile of the window;
// later blocks are never read), 32 / BS blocks a step. A step stages its
// 32 columns of K and V in shared memory, each thread issuing all of its
// 16-byte loads before storing any; rows are
// padded by four floats, so lane c reads K row c in 16-byte pieces without
// bank conflicts. Each warp owns every fourth query vector and keeps its m,
// l and a D/32 slice of acc (dims lane * D/32 ..) in float32 registers: lane
// c scores column c, the warp reduces max and sum, and every lane
// accumulates its slice of P @ V, reading each V row's slice in one piece.
// Window token t sees columns < lens + t; in the tree mode
// (ptt_paged_verify_attention_tree) only those < lens and, of the window,
// its ancestors: bit c - lens of its mask (TreeBits, a kernel argument).
// The mask is a subset of the linear bound (a node's ancestors have
// smaller ids), so the blocks walked stay the same. P enters P @ V in
// V's dtype, which this body only meets as float32 (the TPU kernel's
// p.astype(v.dtype)), so it is never rounded; the sum l and the
// accumulation stay float32. A query vector that sees no column (l == 0)
// writes 0. int8 pools: each 4 values are loaded with their row's scale
// and staged as int8 -> float32 times the scale (the reference's
// dequantization), so everything after is the float32 recipe, P unrounded
// (the TPU kernel's float32 dequantized V).
//
// Shapes: q and out [S, T, H, D]; pools [NB, BS, Hkv, D]; tables
// [S, MB], context_lens [S] int32; H = rep * Hkv, rep <= 64, T <=
// MAX_WINDOW = 1024 (the tree mode: T <= 32, a tree's 31 drafts and its
// root); D in {64, 128}; BS in {8, 16, 32}; float32 or bfloat16 (bfloat16:
// S <= 512, a window of more than 64 / rep rows in several wgmma tiles,
// over any pools; a slot of several tiles is not split);
// pools of q's dtype, float32 pools under a bfloat16 q, or int8 with
// float32 scales
// [NB, BS, Hkv] (bfloat16 q: the Hopper body's int8 mode). Scratch (float32, from the caller): float32
// n_split * S * T * H * (D + 2), n_split <= 16 (a split covers each tile
// of the window); bfloat16 as K2r's.
#include "common.cuh"
#include "paged_attention_sm90.cuh"

namespace {

using namespace ptt;

constexpr int NW = 4;         // warps per block
constexpr int MAX_Q = 64;     // query vectors per block
constexpr int QW = MAX_Q / NW;
constexpr int MAX_T = 32;     // the 32 bits of a tree row's mask
constexpr int MAX_WINDOW = 1024;   // the wrapper's MAX_WINDOW
constexpr int MAX_BS = 32;    // columns staged a step: 32 / BS blocks
// the wrapper's MAX_SPLITS (ops/kernels/paged_attention.py); the merge
// gives each split one lane, so it could take up to 32
constexpr int MAX_SPLITS = 16;
constexpr float MASKED = -1e30f;

// DL consecutive floats of shared memory (DL * 4-byte aligned) in one read
template <int DL>
__device__ __forceinline__ void read_dl(const float* p, float* dst);
template <>
__device__ __forceinline__ void read_dl<4>(const float* p, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
template <>
__device__ __forceinline__ void read_dl<2>(const float* p, float* dst) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  dst[0] = v.x; dst[1] = v.y;
}

static_assert(sizeof(TreeBits) == MAX_T * sizeof(uint32_t),
              "a mask a window row");

// blocks slot s reads: those holding positions < lens + T - 1
__device__ __forceinline__ int live_blocks(int lens, int TW, int BS,
                                           int MB) {
  return min((lens + TW - 1 + BS - 1) / BS, MB);
}

// the body of both kernels: one (slot, kv head, tile, split) block over
// the tile's tokens of a window of TW (grid z: tile * n_split + split)
template <typename T, typename KV, int D>
__device__ __forceinline__ void attend_group(
    const T* __restrict__ q, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ ctx_lens, T* __restrict__ out,
    float* __restrict__ part, int S, int TW, int H, int Hkv, int BS, int MB,
    int rep, int n_split, float scale, const uint32_t* anc_bits) {
  constexpr int DL = D / 32;
  constexpr int DP = D + 4;   // K/V row stride: 16-byte rows, no conflicts
  constexpr int VEC = 16 / sizeof(T);
  static_assert(VEC == 4, "the float32 body: 4 elements a chunk (Kv4)");
  const int s = blockIdx.x, g = blockIdx.y;
  const int split = blockIdx.z % n_split, tile = blockIdx.z / n_split;
  const int t0 = tile * (MAX_Q / rep), nr = min(MAX_Q / rep, TW - t0);
  const int lens = ctx_lens[s];
  const int nblk = live_blocks(lens, t0 + nr, BS, MB);
  const int per = (nblk + n_split - 1) / n_split;
  const int j0 = split * per, j1 = min(j0 + per, nblk);
  if (j0 >= j1 && split > 0) return;
  const int nq = nr * rep;
  const int* trow = tables + (size_t)s * MB;
  // query vector qv is window token t0 + qv / rep, head g * rep + qv % rep
  const size_t v0 = ((size_t)s * TW + t0) * H + (size_t)g * rep;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // [MAX_BS][D + 4]
  float* v_s = k_s + MAX_BS * DP;    // [MAX_BS][D + 4]
  float* q_s = v_s + MAX_BS * DP;    // [nq][D]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < nq * (D / VEC); i += NW * 32) {
    const int qv = i / (D / VEC), dd = (i % (D / VEC)) * VEC;
    const size_t v = v0 + (size_t)(qv / rep) * H + qv % rep;
    load_vec<T>(q + v * D + dd, q_s + qv * D + dd);
  }

  float m[QW], l[QW], acc[QW][DL];
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    m[qi] = MASKED;
    l[qi] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[qi][e] = 0.f;
  }

  // a step's 32 columns of K and V are LOADS 4-element chunks a thread:
  // all of them are loaded into registers before any is stored, so the
  // loads of a step are in flight together
  constexpr int LOADS = MAX_BS * (D / VEC) / (NW * 32);
  const int JB = 32 / BS;
  for (int j = j0; j < j1; j += JB) {
    const int nchunks = min(JB, j1 - j) * BS * (D / VEC);
    Kv4<KV> kraw[LOADS], vraw[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = tid + u * NW * 32;
      if (i < nchunks) {
        const int c = i / (D / VEC), dd = (i % (D / VEC)) * VEC;
        const size_t b = (size_t)trow[j + c / BS];
        const size_t row = (b * BS + c % BS) * Hkv + g;   // scale row
        kraw[u].load(kp + row * D + dd, ks, row);
        vraw[u].load(vp + row * D + dd, vs, row);
      }
    }
    const int ncols = nchunks / (D / VEC);   // columns staged this step
    __syncthreads();  // q staged / previous K-V tile consumed
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = tid + u * NW * 32;
      if (i < nchunks) {
        const int c = i / (D / VEC), dd = (i % (D / VEC)) * VEC;
        float kf[VEC], vf[VEC];
        kraw[u].to_f(kf);
        vraw[u].to_f(vf);
        float4* kd = reinterpret_cast<float4*>(k_s + c * DP + dd);
        float4* vd = reinterpret_cast<float4*>(v_s + c * DP + dd);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          kd[e] = make_float4(kf[4 * e], kf[4 * e + 1], kf[4 * e + 2],
                              kf[4 * e + 3]);
          vd[e] = make_float4(vf[4 * e], vf[4 * e + 1], vf[4 * e + 2],
                              vf[4 * e + 3]);
        }
      }
    }
    __syncthreads();
    const int col = j * BS + lane;
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const int qv = warp + qi * NW;
      if (qv < nq) {  // uniform across the warp
        // the row's ancestor mask (no tree: all ones, the linear bound)
        const uint32_t anc = anc_bits ? anc_bits[t0 + qv / rep] : ~0u;
        const int rel = col - lens;
        const bool live = lane < ncols && col < lens + t0 + qv / rep &&
                          (rel < 0 || (anc >> (rel & 31)) & 1u);
        float sc = MASKED;
        if (live) {
          // 16-byte reads: q broadcast, lane c's K row (rows 4 floats
          // apart in banks, so a quarter warp's reads are disjoint)
          const float4* qr = reinterpret_cast<const float4*>(q_s + qv * D);
          const float4* kr = reinterpret_cast<const float4*>(k_s + lane * DP);
          float dot = 0.f;
#pragma unroll 8
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 a = qr[d4], b = kr[d4];
            dot = fmaf(a.x, b.x, dot);
            dot = fmaf(a.y, b.y, dot);
            dot = fmaf(a.z, b.z, dot);
            dot = fmaf(a.w, b.w, dot);
          }
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
          float vv[DL];
          read_dl<DL>(v_s + c * DP + lane * DL, vv);
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[qi][e] = fmaf(pc, vv[e], acc[qi][e]);
        }
        m[qi] = m_new;
      }
    }
  }

  // one split: normalise and store; several: store the partial state
  const size_t SH = (size_t)S * TW * H;
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    const int qv = warp + qi * NW;
    if (qv < nq) {
      const size_t v = v0 + (size_t)(qv / rep) * H + qv % rep;
      if (n_split == 1) {
        const float inv = 1.f / (l[qi] == 0.f ? 1.f : l[qi]);
        T* o = out + v * D + lane * DL;
#pragma unroll
        for (int e = 0; e < DL; ++e) o[e] = from_f<T>(acc[qi][e] * inv);
      } else {
        float* pa = part + ((size_t)split * SH + v) * D + lane * DL;
#pragma unroll
        for (int e = 0; e < DL; ++e) pa[e] = acc[qi][e];
        if (lane == 0) {
          float* pm = part + (size_t)n_split * SH * D;
          pm[(size_t)split * SH + v] = m[qi];
          pm[(size_t)n_split * SH + (size_t)split * SH + v] = l[qi];
        }
      }
    }
  }
}

// K2d: one query token per slot (the window of one, known here); tree is
// unused (verify_kernel's signature)
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(NW * 32)
    decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                  const KV* __restrict__ vp, const float* __restrict__ ks,
                  const float* __restrict__ vs,
                  const int* __restrict__ tables,
                  const int* __restrict__ ctx_lens, T* __restrict__ out,
                  float* __restrict__ part, int S, int TW, int H, int Hkv,
                  int BS, int MB, int rep, int n_split, float scale,
                  const __grid_constant__ TreeBits tree) {
  attend_group<T, KV, D>(q, kp, vp, ks, vs, tables, ctx_lens, out, part, S,
                         1, H, Hkv, BS, MB, rep, n_split, scale, nullptr);
}

// K2v: a window of TW tokens per slot; TREE: masked by tree.bits
template <typename T, typename KV, int D, bool TREE>
__global__ void __launch_bounds__(NW * 32)
    verify_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                  const KV* __restrict__ vp, const float* __restrict__ ks,
                  const float* __restrict__ vs,
                  const int* __restrict__ tables,
                  const int* __restrict__ ctx_lens, T* __restrict__ out,
                  float* __restrict__ part, int S, int TW, int H, int Hkv,
                  int BS, int MB, int rep, int n_split, float scale,
                  const __grid_constant__ TreeBits tree) {
  attend_group<T, KV, D>(q, kp, vp, ks, vs, tables, ctx_lens, out, part, S,
                         TW, H, Hkv, BS, MB, rep, n_split, scale,
                         TREE ? tree.bits : nullptr);
}

// merge the splits of each query vector: one warp per vector, lane sp
// reading split sp's (m, l) (the splits of its window tile); block z
// covers vectors z * NW .. + NW - 1
template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
    merge_kernel(const int* __restrict__ ctx_lens,
                 const float* __restrict__ part, T* __restrict__ out, int S,
                 int TW, int H, int BS, int MB, int rep, int n_split) {
  constexpr int DL = D / 32;
  const int s = blockIdx.x, g = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qv = blockIdx.z * NW + warp;
  if (qv >= TW * rep) return;  // uniform across the warp
  const int tr = MAX_Q / rep;  // the attend block's tile: its last token
  const int t1 = min(TW, (qv / rep / tr + 1) * tr);
  const int nblk = live_blocks(ctx_lens[s], t1, BS, MB);
  const int per = (nblk + n_split - 1) / n_split;
  const int used = per > 0 ? (nblk + per - 1) / per : 1;  // splits that ran
  const size_t SH = (size_t)S * TW * H;
  const float* pm = part + (size_t)n_split * SH * D;
  const float* pl = pm + (size_t)n_split * SH;
  const size_t v = (size_t)s * TW * H + (size_t)(qv / rep) * H
      + (size_t)g * rep + qv % rep;
  const bool mine = lane < used;
  const float ms = mine ? pm[(size_t)lane * SH + v] : MASKED;
  const float ls = mine ? pl[(size_t)lane * SH + v] : 0.f;
  const float mx = warp_max(ms);
  const float w = mine ? expf(ms - mx) : 0.f;
  const float l = warp_sum(w * ls);
  float acc[DL];
#pragma unroll
  for (int e = 0; e < DL; ++e) acc[e] = 0.f;
  for (int sp = 0; sp < used; ++sp) {
    const float ws = __shfl_sync(FULL_MASK, w, sp);
    const float* pa = part + ((size_t)sp * SH + v) * D;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[e] = fmaf(ws, pa[lane + 32 * e], acc[e]);
  }
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* o = out + v * D;
#pragma unroll
  for (int e = 0; e < DL; ++e) o[lane + 32 * e] = from_f<T>(acc[e] * inv);
}

template <typename T, typename KV, int D>
cudaError_t launch(bool decode, const void* q, const void* kp,
                   const void* vp, const float* ks, const float* vs,
                   const int* tables, const int* ctx, void* out, float* part,
                   int S, int TW, int H, int Hkv, int BS, int MB, int n_split,
                   float scale, cudaStream_t stream,
                   const uint32_t* tree_bits) {
  const int rep = H / Hkv;
  const int tiles = (TW + MAX_Q / rep - 1) / (MAX_Q / rep);
  const int nq = min(TW, MAX_Q / rep) * rep;   // vectors a block
  TreeBits tree = {};
  for (int t = 0; tree_bits != nullptr && t < TW; ++t)
    tree.bits[t] = tree_bits[t];
  auto kernel = decode ? &decode_kernel<T, KV, D>
                : tree_bits != nullptr ? &verify_kernel<T, KV, D, true>
                                       : &verify_kernel<T, KV, D, false>;
  const size_t smem_max = sizeof(float) * (2 * MAX_BS * (D + 4) + MAX_Q * D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (2 * MAX_BS * (D + 4) + nq * D);
  kernel<<<dim3(S, Hkv, n_split * tiles), NW * 32, smem, stream>>>(
      (const T*)q, (const KV*)kp, (const KV*)vp, ks, vs, tables, ctx,
      (T*)out, part, S, TW, H, Hkv, BS, MB, rep, n_split, scale, tree);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  merge_kernel<T, D>
      <<<dim3(S, Hkv, (TW * rep + NW - 1) / NW), NW * 32, 0, stream>>>(
      ctx, part, (T*)out, S, TW, H, BS, MB, rep, n_split);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_d(bool decode, const void* q, const void* kp,
                       const void* vp, const float* ks, const float* vs,
                       const int* tables, const int* ctx, void* out,
                       float* part, int S, int TW, int H, int Hkv, int D,
                       int BS, int MB, int n_split, float scale,
                       cudaStream_t stream, const uint32_t* tree_bits) {
  if (D == 64)
    return launch<T, KV, 64>(decode, q, kp, vp, ks, vs, tables, ctx, out,
                             part, S, TW, H, Hkv, BS, MB, n_split, scale,
                             stream, tree_bits);
  if (D == 128)
    return launch<T, KV, 128>(decode, q, kp, vp, ks, vs, tables, ctx, out,
                              part, S, TW, H, Hkv, BS, MB, n_split, scale,
                              stream, tree_bits);
  return cudaErrorInvalidValue;
}

int run(bool decode, const void* q, const void* kp, const void* vp,
        const void* ks, const void* vs, const void* tables, const void* ctx,
        void* out, void* part, void* counters, int S, int TW, int H, int Hkv,
        int D, int BS, int MB, int NB, int n_split, float scale, int dtype,
        void* stream, const uint32_t* tree_bits) {
  if (S < 1 || TW < 1 || TW > MAX_WINDOW ||
      (tree_bits != nullptr && TW > MAX_T) || (decode && TW != 1) ||
      Hkv < 1 || H % Hkv != 0 || H / Hkv > MAX_Q ||
      (decode && tree_bits != nullptr) ||
      (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* tb = (const int*)tables;
  const int* cl = (const int*)ctx;
  float* pp = (float*)part;
  const float* ksf = (const float*)ks;
  const float* vsf = (const float*)vs;
  if (dtype == 1 || dtype == 2)   // the ragged body, TW rows a slot
    return (int)pa90::launch(q, kp, vp, ksf, vsf, dtype == 2, tb, cl,
                             nullptr, nullptr, out, pp, (int*)counters, S, H,
                             Hkv, D, BS, MB, NB, TW, n_split, scale, st,
                             tree_bits);
  if (dtype != 0 || BS < 1 || BS > MAX_BS ||
      MAX_BS % BS || MB < 1 ||
      n_split < 1 || n_split > MAX_SPLITS ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (ks != nullptr)
    return (int)dispatch_d<float, int8_t>(decode, q, kp, vp, ksf, vsf, tb,
                                          cl, out, pp, S, TW, H, Hkv, D, BS,
                                          MB, n_split, scale, st, tree_bits);
  return (int)dispatch_d<float, float>(decode, q, kp, vp, nullptr, nullptr,
                                       tb, cl, out, pp, S, TW, H, Hkv, D, BS,
                                       MB, n_split, scale, st, tree_bits);
}

}  // namespace

// K2d: q and out [S, 1, H, D] (the decode step's [S, H, D]); dtype 0
// float32, 1 bfloat16, 2 bfloat16 q and out over float32 pools; kp / vp
// pools of q's dtype (ks, vs null; float32 for dtype 2) or int8 pools with
// their float32 scales ks / vs [NB, BS, Hkv]. float32: part is scratch of
// n_split * S * H * (D + 2) floats (unused and may be null when n_split
// == 1), counters unused; bfloat16 and dtype 2: as K2r's
// (ragged_paged_attention.cu) with w_max = 1.
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* tables, const void* ctx, void* out,
    void* part, void* counters, int S, int T, int H, int Hkv, int D, int BS,
    int MB, int NB, int n_split, float scale, int dtype, void* stream) {
  return run(true, q, kp, vp, ks, vs, tables, ctx, out, part, counters, S,
             T, H, Hkv, D, BS, MB, NB, n_split, scale, dtype, stream,
             nullptr);
}

// K2v: q and out [S, T, H, D], 1 <= T <= 1024; pools as K2d's. float32:
// part is scratch of n_split * S * T * H * (D + 2) floats (unused and may
// be null when n_split == 1); bfloat16 and dtype 2: as K2r's with w_max
// = T.
extern "C" int ptt_paged_verify_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* tables, const void* ctx, void* out,
    void* part, void* counters, int S, int T, int H, int Hkv, int D, int BS,
    int MB, int NB, int n_split, float scale, int dtype, void* stream) {
  return run(false, q, kp, vp, ks, vs, tables, ctx, out, part, counters, S,
             T, H, Hkv, D, BS, MB, NB, n_split, scale, dtype, stream,
             nullptr);
}

// K2v's tree mode (T <= 32): as ptt_paged_verify_attention, every slot's
// window row t masked by tree_bits[t] (host memory, T words: row t's
// ancestors, bit j - 1 for window node j; tree_ancestor_bits of
// ops/kernels/paged_attention.py).
extern "C" int ptt_paged_verify_attention_tree(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* tables, const void* ctx, void* out,
    void* part, void* counters, int S, int T, int H, int Hkv, int D, int BS,
    int MB, int NB, int n_split, float scale, int dtype, void* stream,
    const uint32_t* tree_bits) {
  if (tree_bits == nullptr) return (int)cudaErrorInvalidValue;
  return run(false, q, kp, vp, ks, vs, tables, ctx, out, part, counters, S,
             T, H, Hkv, D, BS, MB, NB, n_split, scale, dtype, stream,
             tree_bits);
}
