"""The port's FlashMask attention, masked SDPA and dropout
(``paddle_tpu_torch.ops.kernels.flashmask``, ``ops.flash_attention``,
``nn.functional``) against the JAX package on the CPU.

On a CPU tensor the port runs the plain versions of K6f, K6dq and K6dkv;
here they face the reference's Pallas FlashMask kernels run interpreted
(as ``tests/test_flashmask.py`` runs them): the forward and the q, k and
v gradients through one ``jax.vjp`` per case with a seeded cotangent, at
the reference's six mask layouts, at 64-row blocks (so the reference's
tile skip runs over a 4 x 4 grid), on fully-masked rows and at a tail
length. Float32 throughout. Tolerances: forward 2e-5 absolute (the
reference's own kernel-vs-dense bound), gradients 1e-4 absolute (the
same sums taken in another order; they add up a few hundred terms of
order one); masked SDPA 1e-5, the recipe of ``jax.nn.
dot_product_attention`` repeated in torch ops. Dropout draws from
``torch.Generator``s, so its tests hold distributions and the recipe,
not the reference's bits.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.ops.pallas.flash_attention_kernel as fak
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas.flashmask_kernel import \
    pallas_flashmask_attention
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import flashmask as fm

LAYOUTS = [(2, 4, 2, 2, 1, True),     # GQA + 1-bound causal
           (2, 4, 2, 1, 2, True),     # broadcast mask head + 2 bounds
           (1, 4, 4, 4, 2, False),    # full heads, non-causal interval
           (2, 8, 4, 2, 2, True),     # mask heads != kv heads
           (1, 8, 4, 8, 2, True),     # per-query-head masks (Hm > Hkv)
           (2, 4, 2, 4, 1, True)]     # per-query-head 1-bound


@pytest.fixture
def interpret():
    prev = fak._FORCE_INTERPRET
    fak._FORCE_INTERPRET = True
    yield
    fak._FORCE_INTERPRET = prev


def _document_bounds(rng, L, n_docs, bounds):
    """The reference tests' document bounds: the columns of a document
    ending at row e hide rows [e, L) (and, with two bounds, end at L)."""
    cuts = np.sort(rng.choice(np.arange(16, L - 16), n_docs - 1,
                              replace=False))
    edges = np.concatenate([[0], cuts, [L]])
    start = np.zeros(L, np.int64)
    end = np.full(L, L, np.int64)
    for a, b in zip(edges[:-1], edges[1:]):
        start[a:b] = b
    return np.stack([start, end], -1)[..., :bounds]


def _case(seed, B, L, H, Hkv, Hm, bounds, D=64):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    q, k, v = mk(B, L, H, D), mk(B, L, Hkv, D), mk(B, L, Hkv, D)
    # distinct bounds per (batch, mask head), so a wrong head routing
    # cannot pass
    idx = np.stack([np.stack([_document_bounds(rng, L, 4, bounds)
                              for _ in range(Hm)]) for _ in range(B)])
    return q, k, v, idx.astype(np.int32), mk(B, L, H, D)


def _reference(q, k, v, idx, do, causal, **blocks):
    o, vjp = jax.vjp(lambda a, b, c: pallas_flashmask_attention(
        a, b, c, jnp.asarray(idx), causal=causal, **blocks),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(q, k, v, idx, do, causal):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fm.flashmask_attention_core(*leaves, torch.from_numpy(idx),
                                    causal=causal)
    o.backward(torch.from_numpy(do))
    return [o.detach().numpy()] + [t.grad.numpy() for t in leaves]


def _held(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("B,H,Hkv,Hm,bounds,causal", LAYOUTS)
def test_plain_flashmask_matches_interpreted_pallas(interpret, B, H, Hkv,
                                                    Hm, bounds, causal):
    q, k, v, idx, do = _case(B + H + Hm, B, 256, H, Hkv, Hm, bounds)
    _held(_port(q, k, v, idx, do, causal),
          _reference(q, k, v, idx, do, causal))


def test_plain_flashmask_matches_pallas_at_64_blocks(interpret):
    """The reference at 64-row blocks, so its ``_block_live`` skips tiles
    of the 4 x 4 grid (its own tests run one 256 block); two bounds,
    Hm > Hkv, causal."""
    q, k, v, idx, do = _case(7, 1, 256, 4, 2, 4, 2)
    _held(_port(q, k, v, idx, do, True),
          _reference(q, k, v, idx, do, True, block_q=64, block_k=64))


def test_plain_flashmask_tail_length(interpret):
    """L 200, off the kernels' 64-row tiles, one bound, GQA."""
    q, k, v, idx, do = _case(8, 1, 200, 4, 2, 2, 1)
    _held(_port(q, k, v, idx, do, True),
          _reference(q, k, v, idx, do, True))


def test_plain_flashmask_tiles_summarise_each_column_tile():
    """The tile summary the kernels skip by: ``{max start, min end}`` of
    each 64-column tile of each mask row, at L 200 (a last tile of 8
    columns), two bounds, 3 mask rows."""
    rng = np.random.RandomState(9)
    idx = np.stack([_document_bounds(rng, 200, 4, 2) for _ in range(3)])
    start, end = fm.flashmask_bounds(torch.from_numpy(idx)[None], 200, 3, 1)
    want = [[[int(idx[r, c:c + 64, 0].max()), int(idx[r, c:c + 64, 1].min())]
             for c in range(0, 200, 64)] for r in range(3)]
    assert fm.plain_flashmask_tiles(start, end).tolist() == want


def test_fully_masked_rows_zero_output_lse_and_dq(interpret):
    """Rows [128, 256) hidden on every column: the plain K6 gives o = 0,
    lse = NEG_INF and dq = 0 there exactly, and the interpreted
    reference's o and gradients everywhere."""
    B, H, L, D = 1, 2, 256, 64
    q, k, v, _, do = _case(1, B, L, H, H, 1, 2)
    idx = np.zeros((B, 1, L, 2), np.int32)
    idx[..., 0] = 128
    idx[..., 1] = L
    got = _port(q, k, v, idx, do, False)
    _held(got, _reference(q, k, v, idx, do, False))
    assert np.all(got[0][:, 128:] == 0.0) and np.any(got[0][:, :128] != 0)
    assert np.all(got[1][:, 128:] == 0.0)
    t = torch.from_numpy
    start, end = fm.flashmask_bounds(t(idx), L, H, H)
    _, lse, tiles = fm.flashmask_fwd(t(q), t(k), t(v), start, end,
                                     D ** -0.5, False)
    assert bool((lse[..., 128:] == fa.NEG_INF).all())
    assert tiles.tolist() == [[[128, L]] * (L // 64)]


def test_functional_flashmask_attention_matches_reference():
    """``nn.functional.flashmask_attention`` at the shape of the
    reference's entry-point test (no fully-masked rows, where its dense
    lowering and its kernel agree), causal; and without bounds it is
    ``scaled_dot_product_attention``."""
    B, H, L, D = 1, 2, 128, 32
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(3))
    idx = np.broadcast_to(_document_bounds(rng, L, 2, 1)[None, None],
                          (B, 1, L, 1)).astype(np.int32).copy()
    pt = paddle.to_tensor
    want = JF.flashmask_attention(pt(q), pt(k), pt(v),
                                  startend_row_indices=pt(idx),
                                  causal=True).numpy()
    t = torch.from_numpy
    got = F.flashmask_attention(t(q), t(k), t(v),
                                startend_row_indices=t(idx), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    for causal in (True, False):
        np.testing.assert_array_equal(
            F.flashmask_attention(t(q), t(k), t(v), causal=causal).numpy(),
            F.scaled_dot_product_attention(t(q), t(k), t(v),
                                           is_causal=causal).numpy())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["bool", "float", "bias_hkv"])
def test_sdpa_with_mask_matches_reference(kind, causal):
    """``scaled_dot_product_attention`` with a bool mask ([L, L], True
    keeps), a float mask ([B, 1, L, L], added) and a bias with Hkv heads
    ([B, Hkv, L, L], repeated to the query heads), GQA, against the
    reference's (its XLA path)."""
    B, L, H, Hkv, D = 2, 24, 4, 2, 16
    rng = np.random.RandomState(5)
    q = rng.randn(B, L, H, D).astype(np.float32)
    k, v = (rng.randn(B, L, Hkv, D).astype(np.float32) for _ in range(2))
    if kind == "bool":
        mask = rng.rand(L, L) > 0.3
        mask[:, 0] = True            # every row keeps one column
    elif kind == "float":
        mask = rng.randn(B, 1, L, L).astype(np.float32)
    else:
        mask = rng.randn(B, Hkv, L, L).astype(np.float32)
    pt = paddle.to_tensor
    want = JF.scaled_dot_product_attention(
        pt(q), pt(k), pt(v), attn_mask=pt(mask), is_causal=causal).numpy()
    t = torch.from_numpy
    got = F.scaled_dot_product_attention(t(q), t(k), t(v),
                                         attn_mask=t(mask), is_causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_dropout_keep_rate_scaling_and_modes():
    """Keep rate within 4 sigma of 1 - p, kept values scaled by
    1 / (1 - p) (``upscale_in_train``) or not (``downscale_in_infer``),
    the identity when not training or at p = 0, one mask per ``axis``
    slice, and the same mask from the same generator."""
    x = torch.ones(200, 500)
    p, n = 0.3, x.numel()
    g = torch.Generator().manual_seed(0)
    y = F.dropout(x, p, generator=g)
    kept = float((y != 0).float().mean())
    assert abs(kept - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - p)))
    y2 = F.dropout(x, p, mode="downscale_in_infer",
                   generator=torch.Generator().manual_seed(0))
    assert torch.equal(y2 != 0, y != 0) and bool((y2[y2 != 0] == 1).all())
    assert F.dropout(x, p, training=False) is x
    assert F.dropout(x, 0.0) is x
    ya = F.dropout(x, p, axis=1, generator=g)
    assert bool((ya == ya[:1]).all())        # one mask row, broadcast
    a = F.dropout(x, p, generator=torch.Generator().manual_seed(7))
    b = F.dropout(x, p, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b)


def test_dropout_default_stream_restarts_with_seed():
    """Without a generator, dropout draws from the device's default
    stream: ``seed()`` restarts it, successive draws differ, and PyTorch's
    global generator is not drawn from."""
    x = torch.ones(64, 64)
    trandom.seed(11)
    first = F.dropout(x, 0.5)
    state = torch.get_rng_state()
    second = F.dropout(x, 0.5)
    assert torch.equal(torch.get_rng_state(), state)
    assert not torch.equal(first, second)
    trandom.seed(11)
    assert torch.equal(F.dropout(x, 0.5), first)


def test_attention_dropout_drops_the_output():
    """SDPA's and FlashMask's dropout act on the attention output (the
    reference's choice): with a seeded default stream the dropped output
    is the undropped one through ``dropout`` of the same stream."""
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(1, 64, 2, 64).astype(np.float32))
    idx = torch.full((1, 1, 64, 1), 64, dtype=torch.int32)
    for fn in (lambda **kw: F.scaled_dot_product_attention(
                   q, q, q, is_causal=True, dropout_p=0.25, **kw),
               lambda **kw: F.flashmask_attention(
                   q, q, q, startend_row_indices=idx, causal=True,
                   dropout=0.25)):
        trandom.seed(3)
        got = fn()
        trandom.seed(3)
        want = F.dropout(tfa.flash_attention_core(q, q, q, is_causal=True),
                         0.25)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    out, soft = F.flash_attention.flash_attention(q, q, q, dropout=0.25,
                                                  causal=True,
                                                  training=False)
    assert soft is None
    torch.testing.assert_close(out, tfa.flash_attention_core(
        q, q, q, is_causal=True))


@pytest.mark.parametrize("shape,match", [((1, 3, 64, 1), "must divide"),
                                         ((1, 1, 64, 3), "bounds 1 or 2")])
def test_flashmask_bounds_refuse(shape, match):
    q = torch.zeros(1, 64, 4, 64)
    with pytest.raises(ValueError, match=match):
        F.flashmask_attention(q, q, q, startend_row_indices=torch.zeros(
            shape, dtype=torch.int32))
