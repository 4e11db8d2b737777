// K1dq and K1dkv: the FA-2 backward of flash attention (dq pass and
// dk/dv pass). The kernels, their bound and their design are in
// flash_attention_bwd.cuh (float32) and flash_attention_bwd_sm90.cuh
// (bf16: wgmma + TMA, warp-specialised); K1 runs them with no column
// mask.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention_kernel.py, _dq_kernel
// and _dkv_kernel (via _bwd).
#include "flash_attention_bwd.cuh"

namespace {

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* out0,
        void* out1, int B, int Lq, int Lk, int H, int Hkv, int D, float scale,
        int causal, int dtype, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || H % Hkv != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)ptt::fa::backward(which, dtype, q, k, v, dout,
                                (const float*)lse, (const float*)delta, out0,
                                out1, B, Lq, Lk, H, Hkv, D, scale, causal,
                                ptt::fa::NoMask{}, (cudaStream_t)stream);
}

}  // namespace

// q, dout, dq [B, Lq, H, D]; k, v, dk, dv [B, Lk, Hkv, D]; lse, delta
// [B, H, Lq] float32. D in {64, 128}; dtype 0 = float32, 1 = bfloat16.
extern "C" int ptt_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int Lq, int Lk, int H,
                                      int Hkv, int D, float scale, int causal,
                                      int dtype, void* stream) {
  return run(0, q, k, v, dout, lse, delta, dq, nullptr, B, Lq, Lk, H, Hkv, D,
             scale, causal, dtype, stream);
}

extern "C" int ptt_flash_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int Lq,
                                       int Lk, int H, int Hkv, int D,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  return run(1, q, k, v, dout, lse, delta, dk, dv, B, Lq, Lk, H, Hkv, D,
             scale, causal, dtype, stream);
}
