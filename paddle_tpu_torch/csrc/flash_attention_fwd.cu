// K1f: flash attention forward with the row log-sum-exp,
// o = softmax(scale * Q K^T + causal) V over [B, L, H, D] (GQA: kv head
// h / (H / Hkv)), run with no column mask.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention_kernel.py, _fwd_kernel
// (via _fwd / pallas_flash_attention).
//
// What bounds it on the H100: operations, 4 D flops a visible pair at
// the bf16 tensor-core rate. bfloat16 runs the Hopper kernel of
// flash_attention_fwd_sm90.cuh: wgmma (the only path to that rate), K
// and V tiles streamed by TMA into a ring that a producer warpgroup
// keeps full, two consumer warpgroups that take turns on the tensor
// cores so one's exponentials hide behind the other's products, the
// per-entry mask only on diagonal and tail tiles, and the longest causal
// q tiles launched first. float32 runs on the CUDA cores
// (flash_attention_fwd.cuh), exact to the reference.
#include "flash_attention_fwd.cuh"

// q, o [B, Lq, H, D]; k, v [B, Lk, Hkv, D]; lse [B, H, Lq] float32.
// D in {64, 128}; H % Hkv == 0; dtype 0 = float32, 1 = bfloat16.
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Lq, int Lk, int H, int Hkv,
                                       int D, float scale, int causal,
                                       int dtype, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || H % Hkv != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)ptt::fa::forward(dtype, q, k, v, o, (float*)lse, B, Lq, Lk, H,
                               Hkv, D, scale, causal, ptt::fa::NoMask{},
                               (cudaStream_t)stream);
}
