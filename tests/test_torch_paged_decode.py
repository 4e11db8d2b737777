"""The PyTorch port's paged decode (K2d) and verify (K2v) attention and
the cache writes of ``generate()``'s paged path, held against the JAX
package on the CPU.

The port's plain K2d / K2v versions must match the reference's Pallas
kernels run in interpret mode (rtol = atol = 1e-5 in float32: one
softmax per row over the same float32 scores, summed in another order)
on ragged contexts, GQA groups of 1, 2 and 4, block sizes 8 and 16 and
windows of 1 to 5 tokens; the port's writes must land exactly where the
reference's do, null-routing included. Inputs come from
``numpy.random`` seeds and cross between the packages as numpy arrays.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_cache as jpc
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import paged_cache as tpc
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.ops.kernels import paged_attention as pda

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(rng, lens, T, rep, BS, MB=5, Hkv=2, D=64):
    """Random pools and a window of T query tokens per slot; slot s's
    blocks (enough for lens[s] + T - 1 positions) come from the
    allocator, the rest of its table row stays null."""
    S = len(lens)
    NB = 1 + S * MB
    tables = np.zeros((S, MB), np.int32)
    alloc = tpc.BlockAllocator(NB)
    for s, n in enumerate(lens):
        tables[s, :tpc.blocks_for(n + T - 1, BS)] = alloc.alloc(
            tpc.blocks_for(n + T - 1, BS))
    return dict(q=rng.randn(S, T, Hkv * rep, D).astype(np.float32),
                kp=rng.randn(NB, BS, Hkv, D).astype(np.float32),
                vp=rng.randn(NB, BS, Hkv, D).astype(np.float32),
                tables=tables, lens=np.asarray(lens, np.int32))


def _jnp(c, *keys):
    return [jnp.asarray(c[k]) for k in keys]


@pytest.mark.parametrize("block_size", [8, 16])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_plain_decode_matches_interpreted_kernel(block_size, rep):
    """K2d: ragged contexts, one of them ending on a block boundary and
    one filling the table."""
    rng = np.random.RandomState(10 * block_size + rep)
    lens = [1, block_size, 2 * block_size + 3, 5 * block_size]
    c = _case(rng, lens, 1, rep, block_size)
    want = jpa.pallas_paged_attention(
        jnp.asarray(c["q"][:, 0]), *_jnp(c, "kp", "vp", "tables", "lens"),
        interpret=True)
    got = pda.paged_decode_attention(_t(c["q"][:, 0]), _t(c["kp"]),
                                     _t(c["vp"]), _t(c["tables"]),
                                     _t(c["lens"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("block_size", [8, 16])
@pytest.mark.parametrize("T", [1, 2, 3, 4, 5])
def test_plain_verify_matches_interpreted_kernel(block_size, T):
    """K2v: window token t sees lens + t positions; a window that
    overhangs the last written block, one starting on a block boundary
    and a slot whose window ends exactly at the table's reach."""
    rep = (1, 2, 4)[T % 3]
    rng = np.random.RandomState(100 + 10 * block_size + T)
    reach = 5 * block_size
    lens = [3, block_size, 2 * block_size + 1, reach - T + 1]
    c = _case(rng, lens, T, rep, block_size)
    want = jpa.pallas_paged_verify_attention(
        jnp.asarray(c["q"]), *_jnp(c, "kp", "vp", "tables", "lens"),
        interpret=True)
    got = pda.paged_verify_attention(_t(c["q"]), _t(c["kp"]), _t(c["vp"]),
                                     _t(c["tables"]), _t(c["lens"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_versions_match_reference_fallbacks():
    """The plain versions are the reference's gather fallbacks op for op:
    the same recipe gives the same float32 values, and each verify row
    equals a decode at that row's bound."""
    rng = np.random.RandomState(5)
    c = _case(rng, [6, 11, 1], 3, 2, 8, MB=4)
    want = jpa._xla_paged_verify(jnp.asarray(c["q"]),
                                 *_jnp(c, "kp", "vp", "tables", "lens"))
    got = pda.plain_paged_verify_attention(
        _t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["tables"]),
        _t(c["lens"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(3):
        one = pda.plain_paged_decode_attention(
            _t(c["q"][:, t]), _t(c["kp"]), _t(c["vp"]), _t(c["tables"]),
            _t(c["lens"] + t))
        np.testing.assert_array_equal(got[:, t].numpy(), one.numpy())


def test_writes_land_where_the_reference_puts_them():
    """write_prefill (with n_real null-routing), write_decode and
    write_tokens (positions past MB * BS go to the null block) leave the
    live blocks exactly as the reference's; gather_dense reads them back
    in the same order."""
    rng = np.random.RandomState(3)
    S, P, T, H, D, BS, MB = 2, 7, 4, 2, 8, 4, 3
    NB = 1 + S * MB
    tables = (1 + np.arange(S * MB, dtype=np.int32)).reshape(S, MB)
    kpre = rng.randn(S, P, H, D).astype(np.float32)
    vpre = rng.randn(S, P, H, D).astype(np.float32)
    kdec = rng.randn(S, H, D).astype(np.float32)
    ktok = rng.randn(S, T, H, D).astype(np.float32)
    n_real = np.asarray([5, 7], np.int32)
    lens_dec = np.asarray([7, MB * BS], np.int32)      # slot 1: overflow
    lens_tok = np.asarray([8, MB * BS - 2], np.int32)  # slot 1 overhangs

    jk, jv = jpc.init_pool(NB, BS, H, D, jnp.float32)
    jt = jnp.asarray(tables)
    jk, jv = jpc.write_prefill(jk, jv, jt, jnp.asarray(kpre),
                               jnp.asarray(vpre), n_real=jnp.asarray(n_real))
    jk, jv = jpc.write_decode(jk, jv, jt, jnp.asarray(lens_dec),
                              jnp.asarray(kdec), jnp.asarray(-kdec))
    jk, jv = jpc.write_tokens(jk, jv, jt, jnp.asarray(lens_tok),
                              jnp.asarray(ktok), jnp.asarray(-ktok))

    tk, tv = tpc.init_pool(NB, BS, H, D, torch.float32, "cpu")
    tt = _t(tables)
    assert tpc.write_prefill(tk, tv, tt, _t(kpre), _t(vpre),
                             n_real=_t(n_real))[0] is tk
    tpc.write_decode(tk, tv, tt, _t(lens_dec), _t(kdec), _t(-kdec))
    tpc.write_tokens(tk, tv, tt, _t(lens_tok), _t(ktok), _t(-ktok))
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
    assert tk.numpy()[0].any()          # the overflow went to block 0
    np.testing.assert_array_equal(
        tpc.gather_dense(tk, tt).numpy(),
        np.asarray(jpc.gather_dense(jk, jt)))


def test_write_tokens_equals_sequential_write_decode():
    rng = np.random.RandomState(2)
    S, T, H, D, BS, MB = 2, 3, 2, 8, 4, 4
    tables = _t((1 + np.arange(S * MB, dtype=np.int32)).reshape(S, MB))
    lens = _t(np.asarray([3, 6], np.int32))
    k = _t(rng.randn(S, T, H, D).astype(np.float32))
    a = tpc.init_pool(1 + S * MB, BS, H, D, torch.float32, "cpu")
    b = tpc.init_pool(1 + S * MB, BS, H, D, torch.float32, "cpu")
    tpc.write_tokens(*a, tables, lens, k, -k)
    for t in range(T):
        tpc.write_decode(*b, tables, lens + t, k[:, t], -k[:, t])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("T", [1, 3])
def test_attention_step_matches_reference(T):
    """paged_attention_step (write at cache_lens + t, attend at
    cache_lens + 1 + t) against the reference's on the same pools."""
    rng = np.random.RandomState(20 + T)
    c = _case(rng, [4, 9, 16], T + 1, 2, 8)
    lens = c["lens"]
    kh = rng.randn(3, T, 2, 64).astype(np.float32)
    vh = rng.randn(3, T, 2, 64).astype(np.float32)
    q = c["q"][:, :T]
    jout, jk, jv = jpa.paged_attention_step(
        jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh),
        *_jnp(c, "kp", "vp", "tables", "lens"))
    kp, vp = _t(c["kp"]), _t(c["vp"])
    out, kp2, vp2 = tpa.paged_attention_step(
        _t(q), _t(kh), _t(vh), kp, vp, _t(c["tables"]), _t(lens))
    assert kp2 is kp and vp2 is vp      # in place
    np.testing.assert_array_equal(kp.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(vp.numpy()[1:], np.asarray(jv)[1:])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.RandomState(4)
    c = _case(rng, [3, 8], 2, 2, 8)
    n0 = dict(launch_counts)
    pda.paged_verify_attention(_t(c["q"]), _t(c["kp"]), _t(c["vp"]),
                               _t(c["tables"]), _t(c["lens"]))
    pda.paged_decode_attention(_t(c["q"][:, 0]), _t(c["kp"]), _t(c["vp"]),
                               _t(c["tables"]), _t(c["lens"]))
    assert launch_counts == n0


def test_wrappers_raise_on_backward_with_grad_enabled():
    """K2d / K2v have no backward: with gradients enabled on a query
    that requires them, ``backward()`` raises naming the kernel."""
    rng = np.random.RandomState(6)
    c = _case(rng, [3, 8], 2, 2, 8)
    q = _t(c["q"]).requires_grad_()
    rest = (_t(c["kp"]), _t(c["vp"]), _t(c["tables"]), _t(c["lens"]))
    with pytest.raises(NotImplementedError, match="paged_verify_attention"):
        pda.paged_verify_attention(q, *rest).sum().backward()
    with pytest.raises(NotImplementedError, match="paged_decode_attention"):
        pda.paged_decode_attention(q[:, 0], *rest).sum().backward()
    with torch.no_grad():
        assert pda.paged_verify_attention(q, *rest).grad_fn is None


@pytest.mark.parametrize("T,rep", [(1, 4), (1, 7), (5, 4), (5, 7), (3, 1)])
def test_plain_decode_and_verify_match_interpreted_kernel_bf16(T, rep):
    """bfloat16 pools and queries (the generate() dtype): the plain K2d /
    K2v against the interpreted kernels at atol = rtol = 2e-2 (both round
    P and the output to bfloat16, against running and final row maxima;
    N(0, 1) inputs differ by about one bfloat16 ulp of the output)."""
    rng = np.random.RandomState(200 + 10 * T + rep)
    lens = [1, 16, 2 * 16 + 3, 5 * 16 - T + 1]
    c = _case(rng, lens, T, rep, 16)
    bf = {k: c[k].astype(jnp.bfloat16) for k in ("q", "kp", "vp")}
    args = (jnp.asarray(bf["kp"]), jnp.asarray(bf["vp"]),
            *_jnp(c, "tables", "lens"))
    tt = lambda k: _t(c[k]).to(torch.bfloat16)  # noqa: E731
    if T == 1:
        want = jpa.pallas_paged_attention(jnp.asarray(bf["q"][:, 0]), *args,
                                          interpret=True)
        got = pda.paged_decode_attention(tt("q")[:, 0], tt("kp"), tt("vp"),
                                         _t(c["tables"]), _t(c["lens"]))
    else:
        want = jpa.pallas_paged_verify_attention(jnp.asarray(bf["q"]), *args,
                                                 interpret=True)
        got = pda.paged_verify_attention(tt("q"), tt("kp"), tt("vp"),
                                         _t(c["tables"]), _t(c["lens"]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=2e-2, atol=2e-2)
