// The bf16 body of the fused decode-tick projections for Hopper (sm_90a),
// included by norm_matmul.cu (K3a) and matmul_residual.cu (K3b):
//
//   K3a: out_i[R, n_i] = norm(x)[R, K] @ W_i[K, n_i] (+ b_i), i < nw <= 3,
//        norm rms: bf16(x * rstd) * gamma, ln: bf16((x - mean) * rstd) *
//        gamma + beta (each product and sum rounded to bf16), one norm for
//        all the projections;
//   K3b: out[R, n] = residual + act(xs)[R, K] @ W[K, n] (+ b), act none,
//        swiglu (bf16(bf16(silu(g)) * u)) or gelu_tanh (bf16(gelu(x))).
//
// Replaces: paddle_tpu/ops/pallas/decode_fused.py, _norm_mm_kernel (call
// :300) and _mm_res_kernel (call :335), every mode of both.
//
// What bounds it on the H100: bytes. A serving tick holds R rows (8 at a
// decode tick, 136 at a prefill tick of 128 + 8), so a weight byte
// carries 2R / 2 = R flops: below the ~295 where the tensor cores become
// the limit until R ~ 256. The weights (33-235 MB a projection at
// Llama-3-8B widths) are the bytes; the activations are ~1 MB.
//
// Design (persistent, warp-specialised; hopper.cuh's pieces):
// - One block an SM. Every block holds all the rows of its work: up to
//   three m64 row groups (MG), one per consumer warpgroup, so each weight
//   byte is read from device memory once. Above 192 rows the rows are cut
//   into row blocks of MG x 64 (MG = what pads least), each a pass of its
//   own over the weights.
// - Work is stream-K over (segment, K slice): a segment is one 128-column
//   tile of one projection (K3a concatenates its projections' tiles) for
//   one row block, a slice 64 deep. Block b takes the contiguous range
//   [b * per, (b + 1) * per) of all segments' slices, per = max(MIN_PER,
//   ceil(slices / SMs)), so every block streams the same bytes whatever
//   the shape: no wave tail, and no split factor to choose. A segment
//   whose slices lie in one block is stored by it; one cut between blocks
//   is summed in order of K: every later piece (the first segment of its
//   block, done first) writes its float32 partial, in the accumulator's
//   register layout, to a workspace slot of its block and adds one to
//   the segment's flag; the piece of lowest K (the last segment of its
//   block, done last) waits for the others' flags, adds their partials
//   to its registers in order of K and runs the epilogue. No float
//   atomics: two calls give the same bits. The owner resets the flag.
//   Warps whose rows all lie past R neither write nor read partials.
// - A producer warpgroup (one thread issues TMA; setmaxnreg 24 at three
//   row groups) streams each slice into a ring of STAGES stages with
//   "full" and "empty" mbarriers: the weight tile as two 64 x 64 boxes of
//   W [K, N] (MN-major; the second skipped past N), the rows as one box of
//   (64 columns, MG x 64 rows) of x [R, K], rows past R filled with zeros
//   by TMA. Weights are loaded L2 evict-first (read once), the rows
//   evict-last (every block reads them): o-projection 0.0337 -> 0.0290
//   ms at R = 136 on the H100.
// - Consumer warpgroup c owns row group c. For each slice it issues
//   wgmma m64n128k16 with A from registers and B MN-major from shared
//   memory (wgmma_rs_tb), and while they run reads the next slice's A
//   fragments by ldmatrix and applies K3a's norm to them (two register
//   buffers, swapped by unrolling the slice loop by two), rounding as the
//   plain version: bf16(x * rstd), then the product with gamma as one
//   bf16x2 multiply (exact in float32, so rounded once, as the plain
//   version's), then beta in float32.
// - The row statistics (rstd, and the mean for ln) come from a pre-pass,
//   one warp a row. K3b's swiglu and gelu_tanh come from a pre-pass that
//   activates each element once into R x K rows of scratch (L2-resident
//   at tick widths): applied per column tile in registers they ran up to
//   32 times an element, MUFU-bound (two transcendentals an element).
//   The main kernel is launched behind a pre-pass by programmatic
//   dependent launch: behind the statistics its producer streams at once
//   and the consumers wait (griddepcontrol.wait) before reading them;
//   behind the activation the producer loads the first stages' weights,
//   then waits before it loads the rows.
// - Epilogue in the wgmma register layout: the product rounded to bf16,
//   plus the bias (rounded), plus the residual (rounded), stored as bf16
//   pairs (rows below R, columns below N): the plain version's order.
//   The outputs are ~3 % of the bytes, so the pairs are stored as they
//   lie in registers, the loads of 8 column groups issued before their
//   stores.
// - Host: the tensor maps are kept by address and shape (cached_map),
//   the SM count and the shared-memory attribute asked once a device.
#pragma once

#include <mutex>

#include "hopper.cuh"
#include "mma_gemm.cuh"

namespace ptt {
namespace dg90 {
// internal to each source that includes it (norm_matmul.cu and
// matmul_residual.cu): the host statics below (the SM counts, the map
// cache, the shared-memory attribute's bits) must be per library, as each
// library has its own copy of the kernels
namespace {

constexpr int BN = 128;         // output columns of a tile
constexpr int BK = 64;          // reduction depth of a slice
constexpr int ATOM = 64 * 64;   // elements of a 64-row swizzle atom
constexpr int MAX_MG = 3;       // row groups a block holds
constexpr int MIN_PER = 4;      // least slices a block streams
constexpr int MAX_NW = 3;       // projections of one call
constexpr int RING_BYTES = 225280;
// the prologue the consumers apply to A: none (the rows as they are, or
// as the activation pre-pass wrote them), or the norm of K3a
constexpr int A_NONE = 0, A_RMS = 1, A_LN = 2;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int MG>
struct Cfg {
  static constexpr int THREADS = 128 * (MG + 1);
  static constexpr int STAGE_ELEMS = (2 + MG) * ATOM;   // B, then A
  static constexpr int STAGE_BYTES = STAGE_ELEMS * 2;
  static constexpr int STAGES =
      RING_BYTES / STAGE_BYTES < 8 ? RING_BYTES / STAGE_BYTES : 8;
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
  // setmaxnreg at three row groups: the launch bound leaves the consumers
  // 128 registers (two row groups leave them 168). The block holds
  // THREADS x LAUNCH_REGS registers (ptxas allocates the launch bound, in
  // eights, to a kernel that reallocates); the consumers can take no more
  // than the producer gives back.
  static constexpr bool REALLOC = MG >= 3;
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int REGS_CONSUMER =
      (THREADS * LAUNCH_REGS - 128 * 24) / (128 * MG) / 8 * 8;
  static_assert(!REALLOC || REGS_CONSUMER >= LAUNCH_REGS, "setmaxnreg.inc");
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// the work of one call, set by the host (schedule) and the wrapper
struct Params {
  int R, K, nk, nrb, per, nw;
  int t_end[MAX_NW];     // cumulative column tiles of the projections
  int N[MAX_NW];
  bf16* out[MAX_NW];
  const bf16* bias[MAX_NW];   // or null
  const bf16* res;            // K3b's residual [R, N[0]], or null
  const bf16* gamma;          // K3a's norm
  const bf16* beta;           // ln's, or null
  const float2* stats;        // {rstd, mean} a row (K3a)
  float4* ws;                 // [grid][MG][16][128] partials
  int* flags;                 // [segments][MAX_MG]
};

__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// keep A fragments in their registers up to this point (a wgmma that
// reads them is in flight until the wait before it)
__device__ __forceinline__ void fence_a(uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ float2 bf2f(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t f2bf(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// a * b of two bf16 pairs, rounded once: the exact product of two bf16
// values fits a float32, so this is the float32 product rounded to bf16
__device__ __forceinline__ uint32_t mul_bf2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 h =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the tanh-approximated gelu in float32, its terms in PyTorch's order
__device__ __forceinline__ float gelu1(float x) {
  const float k0 = 0.7978845608028654f, k1 = 0.044715f;
  return 0.5f * x * (1.f + tanhf(k0 * (x + k1 * (x * x * x))));
}

// the bf16 pair at p + k (4-byte aligned) as raw bits, zeros at k >= K
__device__ __forceinline__ uint32_t pair_at(const bf16* p, int k, int K) {
  return k < K ? __ldg(reinterpret_cast<const uint32_t*>(p + k)) : 0u;
}

// tile t's projection and first column
__device__ __forceinline__ void tile_proj(const Params& p, int t, int& proj,
                                          int& c0) {
  proj = t < p.t_end[0] ? 0 : (t < p.t_end[1] ? 1 : 2);
  c0 = (t - (proj ? p.t_end[proj - 1] : 0)) * BN;
}

// The norm on one slice's raw A fragments of this thread: a[kk] is k16
// step kk, registers 0 / 2 rows ra, 1 / 3 row ra + 8; 0 / 1 columns
// k, k + 1, 2 / 3 columns k + 8, k + 9 (the mma.sync m16n8k16 A layout).
// st[h]: {rstd, mean} of row ra + 8 h; g / bt: the slice's gamma / beta
// pairs at the thread's columns ([kk][0]: k, [kk][1]: k + 8). Rounds as
// the plain version: bf16((x - mean) * rstd), times gamma, plus beta.
template <int ACT>
__device__ __forceinline__ void norm_frags(uint32_t (&a)[BK / 16][4],
                                           const float2 (&st)[2],
                                           const uint32_t (&g)[BK / 16][2],
                                           const uint32_t (&bt)[BK / 16][2],
                                           bool beta) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = bf2f(a[kk][i]);
      const float rs = st[i & 1].x, m = ACT == A_LN ? st[i & 1].y : 0.f;
      const uint32_t y = mul_bf2(
          ACT == A_LN ? f2bf((v.x - m) * rs, (v.y - m) * rs)
                      : f2bf(v.x * rs, v.y * rs),
          g[kk][i >> 1]);
      if (ACT == A_LN && beta) {
        const float2 z = bf2f(y), b = bf2f(bt[kk][i >> 1]);
        a[kk][i] = f2bf(z.x + b.x, z.y + b.y);
      } else {
        a[kk][i] = y;
      }
    }
}

// grid: ceil(slices / per) blocks (at most one an SM), Cfg::THREADS
// threads, Cfg::SMEM bytes. ta: 2-D map over the rows [R, K], box (64,
// MG x 64); tb[i]: 2-D map over W_i [K, N_i], box (64, 64). DEP: the rows
// come from the pre-pass the kernel was launched behind (the producer
// loads the first stages' weights, then waits for it).
template <int MG, int ACT, bool DEP>
__global__ void __launch_bounds__(Cfg<MG>::THREADS, 1)
    decode_gemm(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb0,
                const __grid_constant__ CUtensorMap tb1,
                const __grid_constant__ CUtensorMap tb2, const Params p) {
  using namespace sm90;
  using C = Cfg<MG>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char dg_raw[];
  unsigned char* base =
      dg_raw + ((1024 - (smem_u32(dg_raw) & 1023)) & 1023);
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

  const int total = p.t_end[p.nw - 1] * p.nrb * p.nk;
  const int lo = blockIdx.x * p.per, hi = min(total, lo + p.per);
  const int wg = __shfl_sync(FULL_MASK, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if constexpr (C::REALLOC) regs_dealloc<24>();
    if (threadIdx.x == 0) {
      prefetch_tmap(&ta);
      prefetch_tmap(&tb0);
      // f(it, kb, row0, tb, c0, two) for each slice of the block's range
      auto walk = [&](auto&& f) {
        int it = 0;
        for (int idx = lo; idx < hi;) {
          const int seg = idx / p.nk, k0 = idx - seg * p.nk;
          const int k1 = min(p.nk, k0 + hi - idx);
          const int tile = seg / p.nrb;
          int proj, c0;
          tile_proj(p, tile, proj, c0);
          const CUtensorMap* tb =
              proj == 0 ? &tb0 : (proj == 1 ? &tb1 : &tb2);
          for (int kb = k0; kb < k1; ++kb, ++it)
            f(it, kb, (seg - tile * p.nrb) * MG * 64, tb, c0,
              c0 + 64 < p.N[proj]);
          idx += k1 - k0;
        }
      };
      // the stage's weights (its expected bytes, the rows' included)
      // L2 policies: each weight byte is read once, the rows by every
      // block (and the partials are read back soon)
      const uint64_t stream_once = l2_evict_first(), keep = l2_evict_last();
      auto load_b = [&](int it, int kb, const CUtensorMap* tb, int c0,
                        bool two) {
        const int s = it % STAGES;
        bf16* st = ring + s * C::STAGE_ELEMS;
        mbar_expect_tx(full + s, ((two ? 2 : 1) + MG) * ATOM * 2);
        tma_load_2d(st, tb, full + s, c0, kb * BK, stream_once);
        if (two)
          tma_load_2d(st + ATOM, tb, full + s, c0 + 64, kb * BK, stream_once);
      };
      const int pre = DEP ? min(STAGES, hi - lo) : 0;
      if (DEP) {   // the first stages' weights stream during the pre-pass
        walk([&](int it, int kb, int, const CUtensorMap* tb, int c0,
                 bool two) {
          if (it < pre) load_b(it, kb, tb, c0, two);
        });
        grid_dep_wait();
      }
      walk([&](int it, int kb, int row0, const CUtensorMap* tb, int c0,
               bool two) {
        const int s = it % STAGES;
        if (it >= pre) {
          mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
          load_b(it, kb, tb, c0, two);
        }
        tma_load_2d(ring + s * C::STAGE_ELEMS + 2 * ATOM, &ta, full + s,
                    kb * BK, row0, keep);
      });
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C::REALLOC) regs_alloc<C::REGS_CONSUMER>();
    const int c = wg - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, q = lane % 4;
    const int rloc = 64 * c + 16 * warp + lane / 4;   // rows +0, +8
    if (ACT != A_NONE) grid_dep_wait();
    int it = 0;
    for (int idx = lo; idx < hi;) {
      const int seg = idx / p.nk, k0 = idx - seg * p.nk;
      const int n = min(p.nk, k0 + hi - idx) - k0;   // slices
      const int tile = seg / p.nrb;
      const int ra = (seg - tile * p.nrb) * MG * 64 + rloc;
      float2 st[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      if (ACT != A_NONE) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (ra + 8 * h < p.R) st[h] = p.stats[ra + 8 * h];
      }
      float acc[BN / 2];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
      // slice i's A fragments into a: the norm's gamma / beta loads go
      // out before the wait for the stage
      auto fetch = [&](uint32_t (&a)[BK / 16][4], int i) {
        const int s = (it + i) % STAGES, k = (k0 + i) * BK + 2 * q;
        uint32_t g[BK / 16][2], bt[BK / 16][2];
        if constexpr (ACT != A_NONE) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              g[kk][h] = pair_at(p.gamma, k + 16 * kk + 8 * h, p.K);
              if (ACT == A_LN && p.beta)
                bt[kk][h] = pair_at(p.beta, k + 16 * kk + 8 * h, p.K);
            }
        }
        mbar_wait(full + s, ((it + i) / STAGES) & 1);
        const bf16* rows = ring + s * C::STAGE_ELEMS + (2 + c) * ATOM;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          ldsm_a_sw128<64>(a[kk], rows, 16 * warp, kk);
        if constexpr (ACT != A_NONE)
          norm_frags<ACT>(a, st, g, bt, p.beta != nullptr);
      };
      // slice i's products on a, the next slice's fragments into b while
      // they run, then the stage back to the producer
      auto step = [&](uint32_t (&a)[BK / 16][4], uint32_t (&b)[BK / 16][4],
                      int i) {
        const int s = (it + i) % STAGES;
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
      fetch(a0, 0);
      for (int i = 0; i < n; i += 2) {
        step(a0, a1, i);
        if (i + 1 < n) step(a1, a0, i + 1);
      }
      it += n;

      // -------------------------------------------------- the segment's end
      const int b_first = seg * p.nk / p.per;
      const int b_last = ((seg + 1) * p.nk - 1) / p.per;
      int* flag = p.flags + seg * MAX_MG + c;
      const bool live = ra - lane / 4 < p.R;   // the warp has rows to store
      bool store = true;
      if (b_first != b_last) {
        if ((int)blockIdx.x != b_first) {   // a later piece: hand it over
          float4* w = p.ws + ((size_t)blockIdx.x * MG + c) * 16 * 128 + tid;
          if (live) {
#pragma unroll
            for (int i = 0; i < 16; ++i)
              w[i * 128] = make_float4(acc[4 * i], acc[4 * i + 1],
                                       acc[4 * i + 2], acc[4 * i + 3]);
            __threadfence();
          }
          bar_sync(1 + c, 128);
          if (tid == 0) atomicAdd(flag, 1);
          store = false;
        } else {   // the first piece: add the later ones in order of K
          if (tid == 0) {
            while (ld_acquire(flag) < b_last - b_first) __nanosleep(64);
            __threadfence();
          }
          bar_sync(1 + c, 128);
          for (int b = b_first + 1; b <= b_last && live; ++b) {
            const float4* w =
                p.ws + ((size_t)b * MG + c) * 16 * 128 + tid;
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const float4 v = __ldcg(w + i * 128);
              acc[4 * i] += v.x;
              acc[4 * i + 1] += v.y;
              acc[4 * i + 2] += v.z;
              acc[4 * i + 3] += v.w;
            }
          }
          if (tid == 0) *flag = 0;   // ready for the next call
        }
      }
      if (store && live) {
        int proj, c0;
        tile_proj(p, tile, proj, c0);
        const int N = p.N[proj];
        bf16* out = p.out[proj];
        const bf16* bias = p.bias[proj];
        // 8 column groups at a time: their bias and residual loads all go
        // out before the first store (the compiler cannot know that out
        // aliases neither, and would wait for each load in turn)
#pragma unroll
        for (int j0 = 0; j0 < BN / 8; j0 += 8) {
          uint32_t bv[8], rv[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c0 + 8 * (j0 + j) + 2 * q;
            bv[j] = bias ? pair_at(bias, col, N) : 0u;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = ra + 8 * h;
              rv[j][h] = p.res && col < N && r < p.R
                             ? __ldg(reinterpret_cast<const uint32_t*>(
                                   p.res + (size_t)r * N + col))
                             : 0u;
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c0 + 8 * (j0 + j) + 2 * q;
            if (col >= N) continue;
            const float2 b = bf2f(bv[j]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = ra + 8 * h;
              if (r >= p.R) continue;
              const int e = 4 * (j0 + j) + 2 * h;
              float y0 = rbf(acc[e]), y1 = rbf(acc[e + 1]);
              if (bias) {
                y0 = rbf(y0 + b.x);
                y1 = rbf(y1 + b.y);
              }
              if (p.res) {
                const float2 res = bf2f(rv[j][h]);
                y0 += res.x;
                y1 += res.y;
              }
              *reinterpret_cast<uint32_t*>(out + (size_t)r * N + col) =
                  f2bf(y0, y1);
            }
          }
        }
      }
      idx += n;
    }
  }
}

// ------------------------------------------------------------ pre-passes

// row statistics {rstd, mean} of x [R, K], one warp a row: rms (ln 0)
// rstd = 1 / sqrt(mean(x^2) + eps); ln: mean, then the variance of the
// centred row (two passes, as jnp.var). Lets the main kernel launch
// (programmatic dependent launch) before it ends.
__global__ void __launch_bounds__(128)
    row_stats(const bf16* __restrict__ x, float2* __restrict__ stats, int R,
              int K, float eps, int ln) {
  grid_dep_launch();
  const int r = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= R) return;
  const bf16* xr = x + (size_t)r * K;
  float m = 0.f;
  if (ln) {
    float s = 0.f;
    for (int k = lane * 8; k < K; k += 32 * 8) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(xr + k), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[e];
    }
    m = warp_sum(s) / (float)K;
  }
  float ss = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + k), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = fmaf(v[e] - m, v[e] - m, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) stats[r] = make_float2(rsqrtf(ss / (float)K + eps), m);
}

// K3b's activation, once an element, into the rows the main kernel reads:
// out = bf16(bf16(silu(x0)) * x1) (swiglu) or bf16(gelu_tanh(x0)), as
// PyTorch computes them for bf16 (float32, silu as x / (1 + exp(-x)), the
// tanh-gelu's terms in its order); n elements, a multiple of 8.
__global__ void __launch_bounds__(256)
    activate(const bf16* __restrict__ x0, const bf16* __restrict__ x1,
             bf16* __restrict__ out, size_t n, int swiglu) {
  grid_dep_launch();
  for (size_t i = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) * 8; i < n;
       i += (size_t)gridDim.x * blockDim.x * 8) {
    float v[8], u[8], o[8];
    unpack8(*reinterpret_cast<const uint4*>(x0 + i), v);
    if (swiglu) unpack8(*reinterpret_cast<const uint4*>(x1 + i), u);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      o[e] = swiglu ? rbf(v[e] / (1.f + expf(-v[e]))) * u[e] : gelu1(v[e]);
    }
    uint4 w;
    uint32_t* h = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = f2bf(o[2 * e], o[2 * e + 1]);
    *reinterpret_cast<uint4*>(out + i) = w;
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

// row groups of a block for R rows: row blocks of at most MAX_MG x 64
// rows, each as few m64 groups as its share of R needs
inline void row_split(int R, int& nrb, int& mg) {
  nrb = cdiv(R, MAX_MG * 64);
  mg = cdiv(cdiv(R, nrb), 64);
}

// sm90::tmap_2d through a direct-mapped cache keyed by address, shape
// and box (which fix the map): encoding costs the host microseconds a
// map, and a model's weights, and mostly its activations (the caching
// allocator hands out the same blocks tick after tick), come back to the
// same addresses
inline cudaError_t cached_map(CUtensorMap* map, const void* base, int rows,
                              int cols, int box_rows) {
  struct Entry {
    const void* base;
    int rows, cols, box_rows;
    CUtensorMap map;
  };
  static Entry cache[1024];
  static std::mutex lock;
  const size_t slot =
      ((reinterpret_cast<uintptr_t>(base) >> 8) ^ (size_t)box_rows) % 1024;
  std::lock_guard<std::mutex> hold(lock);
  Entry& e = cache[slot];
  if (e.base != base || e.rows != rows || e.cols != cols ||
      e.box_rows != box_rows) {
    const cudaError_t err = sm90::tmap_2d(&e.map, base, rows, cols, box_rows);
    if (err != cudaSuccess) {
      e.base = nullptr;
      return err;
    }
    e.base = base;
    e.rows = rows;
    e.cols = cols;
    e.box_rows = box_rows;
  }
  *map = e.map;
  return cudaSuccess;
}

// a call's schedule and tensor maps (plan)
struct Plan {
  CUtensorMap maps[4];   // the rows, W_0 .. W_2
  int mg, grid, dev;
};

template <int MG, int ACT, bool DEP>
cudaError_t launch_mg(const Plan& pl, const Params& p, cudaStream_t stream) {
  using C = Cfg<MG>;
  auto kernel = decode_gemm<MG, ACT, DEP>;
  static unsigned long long ready = 0;   // the attribute set, a bit a device
  if (pl.dev >= 64 || !(ready >> pl.dev & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    if (pl.dev < 64) ready |= 1ull << pl.dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.grid);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ACT != A_NONE || DEP ? 1 : 0;   // behind a pre-pass
  return cudaLaunchKernelEx(&cfg, kernel, pl.maps[0], pl.maps[1],
                            pl.maps[2], pl.maps[3], p);
}

// the main kernel for prologue ACT (DEP: its rows from the activation
// pre-pass it is launched behind; rms / ln are behind the statistics')
template <int ACT, bool DEP>
cudaError_t launch(const Plan& pl, const Params& p, cudaStream_t stream) {
  switch (pl.mg) {
    case 1: return launch_mg<1, ACT, DEP>(pl, p, stream);
    case 2: return launch_mg<2, ACT, DEP>(pl, p, stream);
    default: return launch_mg<3, ACT, DEP>(pl, p, stream);
  }
}

// A call's schedule and maps: x [R, K] the rows the main kernel reads;
// w[i] [K, N_i]; p's R, K, nw and N set by the caller, its schedule
// fields set here. The scratch: p.ws ws_cap floats (SMs x MAX_MG x 8192
// always suffice), p.flags flag_cap ints (MAX_MG a segment, zeros).
inline cudaError_t plan(const void* x, const void* const* w, Params& p,
                        size_t ws_cap, size_t flag_cap, Plan& pl) {
  row_split(p.R, p.nrb, pl.mg);
  p.nk = cdiv(p.K, BK);
  int tiles = 0;
  for (int i = 0; i < MAX_NW; ++i) {
    if (i < p.nw) tiles += cdiv(p.N[i], BN);
    p.t_end[i] = tiles;
  }
  const long total = (long)tiles * p.nrb * p.nk;
  if ((size_t)tiles * p.nrb * MAX_MG > flag_cap || total > INT32_MAX)
    return cudaErrorInvalidValue;
  const int sms = sm_count(pl.dev);
  p.per = (int)((total + sms - 1) / sms);
  if (p.per < MIN_PER) p.per = MIN_PER;
  pl.grid = (int)((total + p.per - 1) / p.per);
  if ((size_t)pl.grid * pl.mg * 16 * 128 * 4 > ws_cap)
    return cudaErrorInvalidValue;
  cudaError_t err = cached_map(&pl.maps[0], x, p.R, p.K, pl.mg * 64);
  for (int i = 0; i < p.nw && err == cudaSuccess; ++i)
    err = cached_map(&pl.maps[1 + i], w[i], p.K, p.N[i], 64);
  for (int i = p.nw; i < MAX_NW; ++i) pl.maps[1 + i] = pl.maps[1];
  return err;
}

}  // namespace
}  // namespace dg90
}  // namespace ptt
