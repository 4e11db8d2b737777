// K3b: (optional activation ->) projection -> bias -> residual add, as
// one kernel: the O-projection + residual, the swiglu -> down-projection
// + residual of every Llama / Qwen2 decoder layer, and GPT's tanh-gelu ->
// second MLP linear + residual.
//
// Replaces: paddle_tpu/ops/pallas/decode_fused.py, _mm_res_kernel (via
// pallas_matmul_residual), every activation: none, "swiglu", "gelu_tanh".
//
// What bounds it on the H100: at decode widths the weight [K, N]
// dominates the bytes, so the least time is the weight bytes over
// 3.35 TB/s; at prefill widths the multiply-adds take over.
//
// bfloat16 runs one of two Hopper bodies (wgmma, TMA), chosen by the
// shape alone as K3a's (dg90::body_of): the split body of
// decode_gemm_small_sm90.cuh over small weights and at most 192 rows
// (GPT's out_proj and fc2), the stream-K body of decode_gemm_sm90.cuh
// otherwise; swiglu and gelu_tanh first
// run a pre-pass that activates each element once into a scratch of
// R x K rows (L2-resident at tick widths: 3.9 MB at R = 136, K = 14336),
// which the main kernel, launched behind it, reads: applied per column
// tile in registers instead, the activation ran 32 times an element at
// Llama-3-8B's down-projection and held it to half the library call's
// speed. float32 runs the FMA tile of tile_gemm.cuh over a (row tiles,
// column tiles) grid, the activation applied as each K-slice is staged in
// shared memory. Both round where the unfused path rounds (the
// activation in the input dtype; the product, the bias and the residual
// add each in the output dtype).
//
// Shapes: x0 (and x1 for swiglu) [R, K], w [K, N] row-major, bias [N] or
// null, residual and out [R, N]; float32 or bfloat16 throughout.
// bfloat16 needs K and N multiples of 8 and 16-byte aligned pointers;
// float32 takes any sizes.
#include <algorithm>

#include "decode_gemm_small_sm90.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace ptt;

// act: 0 none, 1 swiglu (silu(x0) * x1), 2 gelu_tanh (gelu(x0))
struct ActLoad {
  const float* x0;
  const float* x1;
  int K, act;
  __device__ __forceinline__ float operator()(int r, int k, int) const {
    const size_t i = (size_t)r * K + k;
    const float v = x0[i];
    if (act == 1) return v / (1.f + expf(-v)) * x1[i];
    if (act == 2) return dg90::gelu1(v);
    return v;
  }
};

template <int BM>
__global__ void __launch_bounds__(GEMM_THREADS)
    matmul_residual_fma(ActLoad load, const float* __restrict__ w,
                        const float* __restrict__ bias,
                        const float* __restrict__ res,
                        float* __restrict__ out, int R, int K, int N) {
  constexpr int TM = BM / 16;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * GEMM_BN;
  float acc[TM][4];
  gemm_tile<float, BM>(load, w, R, K, N, row0, col0, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (r < R && c < N) {   // the unfused order: bias, then residual
        const size_t o = (size_t)r * N + c;
        out[o] = res[o] + (bias ? acc[i][j] + bias[c] : acc[i][j]);
      }
    }
  }
}

template <int BM>
cudaError_t launch_fma(const ActLoad& load, const void* w, const void* bias,
                       const void* res, void* out, int R, int K, int N,
                       cudaStream_t stream) {
  dim3 grid((R + BM - 1) / BM, (N + GEMM_BN - 1) / GEMM_BN);
  matmul_residual_fma<BM><<<grid, GEMM_THREADS, 0, stream>>>(
      load, (const float*)w, (const float*)bias, (const float*)res,
      (float*)out, R, K, N);
  return cudaGetLastError();
}

}  // namespace

// act: 0 = none (x0 only), 1 = swiglu (silu(x0) * x1), 2 = gelu_tanh;
// bfloat16 scratch (none for float32): rows act_cap bf16 (swiglu and
// gelu_tanh: R x K, the activated rows), ws ws_cap floats, flags
// flag_cap int32 zeros (decode_gemm_sm90.cuh's plan; the split body reads
// neither ws nor flags)
extern "C" int ptt_matmul_residual(const void* x0, const void* x1,
                                   const void* w, const void* bias,
                                   const void* res, void* out, void* rows,
                                   void* ws, void* flags, long long act_cap,
                                   long long ws_cap, long long flag_cap,
                                   int R, int K, int N, int act, int dtype,
                                   void* stream) {
  if (R < 1 || K < 1 || N < 1 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const ActLoad load{(const float*)x0, (const float*)x1, K, act};
    if (R <= 16)
      return (int)launch_fma<16>(load, w, bias, res, out, R, K, N, st);
    return (int)launch_fma<64>(load, w, bias, res, out, R, K, N, st);
  }
  const size_t n = (size_t)R * K;
  if (dtype != 1 || K % 8 || N % 8 || ws == nullptr || flags == nullptr ||
      (act && (rows == nullptr || (size_t)act_cap < n)))
    return (int)cudaErrorInvalidValue;
  dg90::Params p = {};
  p.R = R;
  p.K = K;
  p.nw = 1;
  p.N[0] = N;
  p.out[0] = (bf16*)out;
  p.bias[0] = (const bf16*)bias;
  p.res = (const bf16*)res;
  p.ws = (float4*)ws;
  p.flags = (int*)flags;
  const void* wp[3] = {w, w, w};
  const void* xa = act ? rows : x0;
  const bool split = dg90::body_of(R, K, p.N, 1) == dg90::BODY_SPLIT_K;
  dg90::Plan pl;
  dg90::SplitPlan sp;
  cudaError_t err = split ? dg90::plan_split(xa, wp, p, sp)
                          : dg90::plan(xa, wp, p, (size_t)ws_cap,
                                       (size_t)flag_cap, pl);
  if (err != cudaSuccess) return (int)err;
  if (act == 0)
    return (int)(split ? dg90::launch_split<false>(sp, p, st)
                       : dg90::launch<dg90::A_NONE, false>(pl, p, st));
  const int blocks = (int)std::min<size_t>((n / 8 + 255) / 256, 4096);
  dg90::activate<<<blocks, 256, 0, st>>>((const bf16*)x0, (const bf16*)x1,
                                         (bf16*)rows, n, act == 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)(split ? dg90::launch_split<true>(sp, p, st)
                     : dg90::launch<dg90::A_NONE, true>(pl, p, st));
}
