// K3a: a norm of the rows (RMSNorm, or LayerNorm with an optional beta)
// fused into the prologue of 1..3 projections that share the normalised
// rows (q/k/v, or the MLP's gate/up), each with an optional bias.
//
// Replaces: paddle_tpu/ops/pallas/decode_fused.py, _norm_mm_kernel (via
// pallas_norm_matmul), every mode: kind "rms" / "ln", beta, biases.
//
// What bounds it on the H100: at decode widths (R = live rows of one
// serving tick, up to a few hundred) the weights dominate the bytes
// (R x d activations against d x sum(n) weights), so the least time is
// the weight bytes over 3.35 TB/s; at prefill widths the multiply-adds
// take over.
//
// bfloat16 runs one of two Hopper bodies (wgmma, TMA) chosen by the
// shape alone (dg90::body_of, reported by ptt_decode_gemm_body): over
// small weights and at most 192 rows (GPT's widths) the split body of
// decode_gemm_small_sm90.cuh (a column tile a thread-block cluster, K
// split over its blocks and summed over distributed shared memory),
// behind a pre-pass that writes the normalised rows into the workspace;
// otherwise the stream-K body of decode_gemm_sm90.cuh (persistent,
// stream-K over the weight tiles, the norm applied to A in registers),
// behind a statistics pre-pass. float32 runs the FMA tile of
// tile_gemm.cuh: the grid is (row tiles, column tiles of the
// concatenated column space of all weights), a first phase computes each
// row's statistics into shared memory, and the product loop stages the
// normalised rows K-slice by K-slice in shared memory, so the normalised
// activation never goes to device memory.
//
// Shapes: x [R, d], gamma and beta [d], w_i [d, n_i] (row-major,
// Paddle's [in, out] layout), b_i [n_i], o_i [R, n_i]; float32 or
// bfloat16 throughout; 1 <= nw <= 3. bfloat16 needs d and every n_i a
// multiple of 8 and 16-byte aligned pointers; float32 takes any sizes.
#include "decode_gemm_small_sm90.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace ptt;

// each row's rstd (and, for ln, mean) in shared memory, as the plain
// version computes them: the mean, then the mean square of the centred
// row (ln) or of the row (rms)
template <typename T, int BM, int THREADS>
__device__ __forceinline__ void row_stats(const T* __restrict__ x, int R,
                                          int d, int row0, float eps, int ln,
                                          float* rstd, float* mean) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < BM; m += THREADS / 32) {
    const int r = row0 + m;
    float mu = 0.f, ss = 0.f;
    if (r < R) {
      const T* xr = x + (size_t)r * d;
      if (ln) {
        for (int k = lane; k < d; k += 32) mu += to_f<T>(xr[k]);
        mu = warp_sum(mu) / (float)d;
      }
      for (int k = lane; k < d; k += 32) {
        const float v = to_f<T>(xr[k]) - mu;
        ss = fmaf(v, v, ss);
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) {
      rstd[m] = rsqrtf(ss / (float)d + eps);
      mean[m] = mu;
    }
  }
  __syncthreads();
}

// which weight a column tile belongs to, and where
template <typename T>
struct ColTile {
  const T* w;
  const T* b;
  T* o;
  int n, col0;
  __device__ ColTile(int ct, int t0, int t1, int bn, const T* const* ws,
                     const T* const* bs, T* const* os, const int* ns) {
    const int i = ct < t0 ? 0 : (ct < t0 + t1 ? 1 : 2);
    w = ws[i];
    b = bs[i];
    o = os[i];
    n = ns[i];
    col0 = (ct - (i > 0 ? t0 : 0) - (i > 1 ? t1 : 0)) * bn;
  }
};

template <typename T, int BM>
struct NormLoad {
  const T* x;
  const T* gamma;
  const T* beta;
  const float* rstd;
  const float* mean;
  int d;
  __device__ __forceinline__ float operator()(int r, int k, int m) const {
    const float yn =
        round_t<T>((to_f<T>(x[(size_t)r * d + k]) - mean[m]) * rstd[m]);
    const float y = round_t<T>(yn * to_f<T>(gamma[k]));
    return beta ? round_t<T>(y + to_f<T>(beta[k])) : y;
  }
};

struct Weights {
  const float* w[3];
  const float* b[3];
  float* o[3];
  int n[3];
};

template <int BM>
__global__ void __launch_bounds__(GEMM_THREADS)
    norm_matmul_fma(const float* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, Weights ws, int R, int d,
                    int t0, int t1, float eps, int ln) {
  constexpr int TM = BM / 16;
  __shared__ float rstd[BM], mean[BM];
  const int row0 = blockIdx.x * BM;
  const ColTile<float> ct(blockIdx.y, t0, t1, GEMM_BN, ws.w, ws.b, ws.o,
                          ws.n);
  row_stats<float, BM, GEMM_THREADS>(x, R, d, row0, eps, ln, rstd, mean);

  float acc[TM][4];
  NormLoad<float, BM> load{x, gamma, beta, rstd, mean, d};
  gemm_tile<float, BM>(load, ct.w, R, d, ct.n, row0, ct.col0, acc);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = ct.col0 + tx * 4 + j;
      if (col < ct.n)
        ct.o[(size_t)r * ct.n + col] = acc[i][j] + (ct.b ? ct.b[col] : 0.f);
    }
  }
}

int tiles(int n, int bn) { return (n + bn - 1) / bn; }

template <int BM>
cudaError_t launch_fma(const void* x, const void* gamma, const void* beta,
                       const Weights& ws, int R, int d, int nw, float eps,
                       int ln, cudaStream_t stream) {
  const int t0 = tiles(ws.n[0], GEMM_BN);
  const int t1 = nw > 1 ? tiles(ws.n[1], GEMM_BN) : 0;
  const int t2 = nw > 2 ? tiles(ws.n[2], GEMM_BN) : 0;
  dim3 grid((R + BM - 1) / BM, t0 + t1 + t2);
  norm_matmul_fma<BM><<<grid, GEMM_THREADS, 0, stream>>>(
      (const float*)x, (const float*)gamma, (const float*)beta, ws, R, d,
      t0, t1, eps, ln);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 = rms, 1 = ln (beta optional); w / b / o: nw weights [d, n_i],
// biases [n_i] or null, outputs [R, n_i]. bfloat16 scratch (none for
// float32): stats float2 [R], ws ws_cap floats, flags flag_cap int32
// zeros (decode_gemm_sm90.cuh's plan; the split body takes R x d bf16
// of ws for the normalised rows, and neither stats nor flags).
extern "C" int ptt_norm_matmul(const void* x, const void* gamma,
                               const void* beta, const void* w0,
                               const void* w1, const void* w2, const void* b0,
                               const void* b1, const void* b2, void* o0,
                               void* o1, void* o2, void* stats, void* ws,
                               void* flags, long long ws_cap,
                               long long flag_cap, int R, int d, int n0,
                               int n1, int n2, int nw, int kind, float eps,
                               int dtype, void* stream) {
  if (nw < 1 || nw > 3 || R < 1 || d < 1 || kind < 0 || kind > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const void* w[3] = {w0, w1, w2};
  const void* b[3] = {b0, b1, b2};
  void* o[3] = {o0, o1, o2};
  const int n[3] = {n0, nw > 1 ? n1 : 0, nw > 2 ? n2 : 0};
  if (dtype == 0) {
    Weights wt;
    for (int i = 0; i < 3; ++i) {
      wt.w[i] = (const float*)w[i];
      wt.b[i] = i < nw ? (const float*)b[i] : nullptr;
      wt.o[i] = (float*)o[i];
      wt.n[i] = n[i];
    }
    if (R <= 16)
      return (int)launch_fma<16>(x, gamma, beta, wt, R, d, nw, eps, kind, st);
    return (int)launch_fma<64>(x, gamma, beta, wt, R, d, nw, eps, kind, st);
  }
  if (dtype != 1 || d % 8 || stats == nullptr || ws == nullptr ||
      flags == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nw; ++i)
    if (n[i] < 1 || n[i] % 8) return (int)cudaErrorInvalidValue;
  dg90::Params p = {};
  p.R = R;
  p.K = d;
  p.nw = nw;
  for (int i = 0; i < 3; ++i) {
    p.N[i] = n[i];
    p.out[i] = (bf16*)o[i];
    p.bias[i] = i < nw ? (const bf16*)b[i] : nullptr;
  }
  p.gamma = (const bf16*)gamma;
  p.beta = kind == 1 ? (const bf16*)beta : nullptr;
  p.stats = (const float2*)stats;
  p.ws = (float4*)ws;
  p.flags = (int*)flags;
  if (dg90::body_of(R, d, n, nw) == dg90::BODY_SPLIT_K) {
    // the normalised rows [R, d] in the workspace, behind them the GEMM
    if ((size_t)ws_cap * sizeof(float) < (size_t)R * d * sizeof(bf16))
      return (int)cudaErrorInvalidValue;
    dg90::SplitPlan sp;
    cudaError_t err = dg90::plan_split(ws, w, p, sp);
    if (err != cudaSuccess) return (int)err;
    dg90::normalize<<<dg90::cdiv(R, dg90::NORM_ROWS), dg90::NORM_ROWS * 32,
                      0, st>>>(
        (const bf16*)x, (const bf16*)gamma, p.beta, (bf16*)ws, R, d, eps,
        kind);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)dg90::launch_split<true>(sp, p, st);
  }
  dg90::Plan pl;
  cudaError_t err =
      dg90::plan(x, w, p, (size_t)ws_cap, (size_t)flag_cap, pl);
  if (err != cudaSuccess) return (int)err;
  dg90::row_stats<<<dg90::cdiv(R, 4), 128, 0, st>>>(
      (const bf16*)x, (float2*)stats, R, d, eps, kind);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)(kind == 0 ? dg90::launch<dg90::A_RMS, false>(pl, p, st)
                         : dg90::launch<dg90::A_LN, false>(pl, p, st));
}

// The bf16 body a call of R rows over K = d and widths n0..n2 (nw of
// them) takes, K3a's or K3b's (nw 1): 0 the stream-K body, 1 the split
// body; for the split body, cfg gets its column tile, its blocks a
// cluster and its blocks. A function of the shape alone; needs no device.
extern "C" int ptt_decode_gemm_body(int R, int K, int n0, int n1, int n2,
                                    int nw, int* cfg) {
  if (nw < 1 || nw > 3 || R < 1 || K < 1) return -1;
  const int n[3] = {n0, nw > 1 ? n1 : 0, nw > 2 ? n2 : 0};
  const int body = dg90::body_of(R, K, n, nw);
  const dg90::Split s = dg90::split_of(K, n, nw);
  cfg[0] = body == dg90::BODY_SPLIT_K ? dg90::SPLIT_BN : 0;
  cfg[1] = body == dg90::BODY_SPLIT_K ? s.split : 0;
  cfg[2] = body == dg90::BODY_SPLIT_K ? s.split * s.tiles : 0;
  return body;
}
