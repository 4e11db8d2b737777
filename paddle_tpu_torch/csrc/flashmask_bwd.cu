// K6dq and K6dkv: the FA-2 backward of attention under the FlashMask
// column mask (flashmask_fwd.cu): a dq pass and a dk/dv pass that
// recompute P from the forward's lse, with P = 0 on every masked entry,
// so a row that sees nothing gets dq = 0 and adds nothing to dk / dv.
//
// Replaces: paddle_tpu/ops/pallas/flashmask_kernel.py, _fm_dq_kernel and
// _fm_dkv_kernel (via _fm_bwd); delta = rowsum(dO * O) comes from the
// caller, as the reference computes it in XLA.
//
// What bounds them on the H100: operations over the visible pairs only
// (6 D flops a pair for dq, 8 D for dk/dv). The kernels are K1's run
// with the ColumnMask policy of flashmask.cuh (in bf16 the wgmma + TMA
// kernels of flash_attention_bwd_sm90.cuh): the dq block (128 q rows)
// walks the 64-column kv tiles its q tile can see; the dk/dv block (128
// kv rows), which sums over the query heads of its kv group, jumps each
// head's range of 64-row q tiles hidden from both 64-column halves of
// its kv tile and masks each entry by that head's own mask row (the TPU
// kernel's _m_row), staged per item by the producer warp with a flag
// per half, so only tiles that a column partly hides take the per-entry
// mask.
#include "flash_attention_bwd.cuh"
#include "flashmask.cuh"

namespace {

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta,
        const void* start, const void* end, const void* tiles, void* out0,
        void* out1, int B, int Lq, int Lk, int H, int Hkv, int Hm, int D,
        float scale, int causal, int dtype, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hm < 1 || H % Hkv != 0 ||
      H % Hm != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)ptt::fa::backward(
      which, dtype, q, k, v, dout, (const float*)lse, (const float*)delta,
      out0, out1, B, Lq, Lk, H, Hkv, D, scale, causal,
      ptt::fa::column_mask(start, end, tiles, Hm, Lk), (cudaStream_t)stream);
}

}  // namespace

// q, dout, dq [B, Lq, H, D]; k, v, dk, dv [B, Lk, Hkv, D]; lse, delta
// [B, H, Lq] float32; start, end [B * Hm, Lk] int32; tiles [B * Hm,
// ceil(Lk / 64)] int2, the summary ptt_flashmask_fwd filled for these
// bounds. D in {64, 128}; H % Hkv == 0 and H % Hm == 0; dtype 0 =
// float32, 1 = bfloat16.
extern "C" int ptt_flashmask_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* start,
                                const void* end, const void* tiles, void* dq,
                                int B, int Lq, int Lk, int H, int Hkv, int Hm,
                                int D, float scale, int causal, int dtype,
                                void* stream) {
  return run(0, q, k, v, dout, lse, delta, start, end, tiles, dq, nullptr, B,
             Lq, Lk, H, Hkv, Hm, D, scale, causal, dtype, stream);
}

extern "C" int ptt_flashmask_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* start,
                                 const void* end, const void* tiles, void* dk,
                                 void* dv, int B, int Lq, int Lk, int H,
                                 int Hkv, int Hm, int D, float scale,
                                 int causal, int dtype, void* stream) {
  return run(1, q, k, v, dout, lse, delta, start, end, tiles, dk, dv, B, Lq,
             Lk, H, Hkv, Hm, D, scale, causal, dtype, stream);
}
