// K6f: flash attention forward under the FlashMask column mask,
// o = softmax(scale * Q K^T + mask) V and the row log-sum-exp, over
// [B, L, H, D] (GQA: kv head h / (H / Hkv); mask row b * Hm + h / (H /
// Hm)). Key column j hides query rows [start_j, end_j), and causal adds
// the triangle. A row that sees nothing gets o = 0 and lse = NEG_INF.
//
// Replaces: paddle_tpu/ops/pallas/flashmask_kernel.py, _fm_fwd_kernel
// (via _fm_fwd / pallas_flashmask_attention).
//
// What bounds it on the H100: operations, over the visible pairs only
// (4 D flops a pair). The kernel is K1f's (flash_attention_fwd.cuh; in
// bf16 the wgmma + TMA kernel of flash_attention_fwd_sm90.cuh) run with
// the ColumnMask policy of flashmask.cuh: a tile-summary pass first (64
// columns a tile, which the backward's entries reuse), then each
// 128-row q tile walks only the 128-column kv tiles it can see (a tile
// is live if either 64-column half is), so a document mask costs its
// documents' pairs and not L^2. The producer warp stages each tile's
// column bounds beside its K copy and flags whether any column hides a
// row of the q tile; only flagged, diagonal and tail tiles take the
// per-entry mask.
#include "flash_attention_fwd.cuh"
#include "flashmask.cuh"

// q, o [B, Lq, H, D]; k, v [B, Lk, Hkv, D]; start, end [B * Hm, Lk]
// int32; tiles [B * Hm, ceil(Lk / 64)] int2, filled here with the tile
// summary the backward's entries read; lse [B, H, Lq] float32. D in
// {64, 128}; H % Hkv == 0 and H % Hm == 0; dtype 0 = float32, 1 =
// bfloat16.
extern "C" int ptt_flashmask_fwd(const void* q, const void* k,
                                 const void* v, const void* start,
                                 const void* end, void* tiles, void* o,
                                 void* lse, int B, int Lq, int Lk, int H,
                                 int Hkv, int Hm, int D, float scale,
                                 int causal, int dtype, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hm < 1 || H % Hkv != 0 ||
      H % Hm != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = ptt::fa::tile_summary(start, end, tiles, B, Hm,
                                                Lk, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)ptt::fa::forward(
      dtype, q, k, v, o, (float*)lse, B, Lq, Lk, H, Hkv, D, scale, causal,
      ptt::fa::column_mask(start, end, tiles, Hm, Lk), (cudaStream_t)stream);
}
