"""The paged serving steps' write + attend (counterparts of
``ragged_attention_step`` and ``paged_attention_step`` in
``paddle_tpu/ops/pallas/paged_attention.py``).
"""
from __future__ import annotations

import torch

from .kernels import paged_attention as _pda
from .kernels import ragged_paged_attention as _rpa
from .paged_cache import write_decode, write_rows, write_tokens

__all__ = ["ragged_attention_step", "paged_attention_step"]


def ragged_attention_step(qh, kh, vh, k_pool, v_pool, block_tables,
                          cache_lens, q_lens, row_starts, row_slot,
                          row_pos, w_max, sm_scale=None,
                          tree_anc=_pda._AMBIENT, tree_slots=_pda._AMBIENT,
                          tree_rows=_pda._AMBIENT):
    """Scatter this tick's per-row K/V (``[R, H_kv, D]``) into the pools
    at ``(row_slot, row_pos)`` — pad rows go to the null block — then
    attend each packed query row against its slot's blocks.
    ``cache_lens[s]`` is slot ``s``'s valid length before this tick's
    first row, so the attention sees ``cache_lens + 1`` positions at the
    slot's first row (the row itself included). ``w_max`` (host int)
    bounds ``q_lens``. ``tree_anc`` / ``tree_slots`` / ``tree_rows``
    (K2r's tree mode) default to the ambient ``spec_tree_scope`` and are
    passed on explicitly (None: linear). The pools are updated in place.
    Returns ``(out [R, H, D], k_pool, v_pool)``."""
    amb = _pda._tree_ctx()
    if tree_anc is _pda._AMBIENT:
        tree_anc = amb[0]
    if tree_slots is _pda._AMBIENT:
        tree_slots = amb[1] if tree_anc is not None else None
    if tree_rows is _pda._AMBIENT:
        tree_rows = amb[2] if tree_anc is not None else None
    write_rows(k_pool, v_pool, block_tables, row_slot, row_pos, kh, vh)
    out = _rpa.ragged_paged_attention(
        qh, k_pool, v_pool, block_tables, cache_lens + 1, q_lens,
        row_starts, w_max, sm_scale=sm_scale, tree_anc=tree_anc,
        tree_slots=tree_slots, tree_rows=tree_rows)
    return out, k_pool, v_pool


def paged_attention_step(qh, kh, vh, k_pool, v_pool, block_tables,
                         cache_lens, sm_scale=None):
    """Write this step's K/V (``[S, T, H_kv, D]``) at ``cache_lens[s] +
    t`` and attend ``qh [S, T, H, D]``: T = 1 is generate()'s paged
    decode step (K2d), T > 1 the speculative verify window (K2v, token
    ``t`` sees ``cache_lens + 1 + t`` positions, or, inside a
    ``spec_tree_scope`` of T - 1 nodes, the prefix and its ancestors in
    the window). The pools are updated in place. Returns ``(out [S, T,
    H, D], k_pool, v_pool)``."""
    lens = cache_lens.to(torch.int32)
    if qh.shape[1] == 1:
        write_decode(k_pool, v_pool, block_tables, lens, kh[:, 0], vh[:, 0])
        out = _pda.paged_decode_attention(qh[:, 0], k_pool, v_pool,
                                          block_tables, lens + 1,
                                          sm_scale=sm_scale)
        return out[:, None], k_pool, v_pool
    write_tokens(k_pool, v_pool, block_tables, lens, kh, vh)
    out = _pda.paged_verify_attention(
        qh, k_pool, v_pool, block_tables, lens + 1, sm_scale=sm_scale,
        tree_anc=_pda.window_tree(_pda._tree_ctx()[0], qh.shape[1]))
    return out, k_pool, v_pool
