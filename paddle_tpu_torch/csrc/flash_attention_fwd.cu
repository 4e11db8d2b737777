// K1f: flash attention forward with the row log-sum-exp,
// o = softmax(scale * Q K^T + causal) V over [B, L, H, D] (GQA: kv head
// h / (H / Hkv)). The kernels, their bound and their design are in
// flash_attention_fwd.cuh; K1f runs them with no column mask.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention_kernel.py, _fwd_kernel
// (via _fwd / pallas_flash_attention).
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
