"""The PyTorch port's paged KV cache and ragged paged attention (K2r),
held against the JAX package on the CPU.

The port's plain K2r version must match the reference's ragged Pallas
kernel run in interpret mode on live rows (rtol = atol = 1e-5 in
float32: both are one softmax per row over the same f32 scores, summed
in a different order), and the port's cache scatter must land exactly
where the reference's does. Inputs come from ``numpy.random`` seeds and
cross between the packages as numpy arrays.
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
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _batch(rng, base, q_lens, H=8, Hkv=4, D=64, BS=8, MB=6, extra_rows=0):
    """A ragged batch over a random pool: slot s has q_lens[s] rows whose
    first sits at cache position base[s]; blocks come from the
    allocator in admission order."""
    S = len(base)
    NB = 1 + S * MB
    kp = rng.randn(NB, BS, Hkv, D).astype(np.float32)
    vp = rng.randn(NB, BS, Hkv, D).astype(np.float32)
    tables = np.zeros((S, MB), np.int32)
    alloc = tpc.BlockAllocator(NB)
    for s in range(S):
        n = tpc.blocks_for(int(base[s]) + int(q_lens[s]), BS)
        if n:
            tables[s, :n] = alloc.alloc(n)
    R = int(np.sum(q_lens)) + extra_rows
    row_slot, row_pos, row_starts, last = tpc.ragged_row_meta(
        q_lens, base, R, MB * BS)
    q = rng.randn(R, H, D).astype(np.float32)
    return dict(q=q, kp=kp, vp=vp, tables=tables,
                ctx=(np.asarray(base) + 1).astype(np.int32),
                q_lens=np.asarray(q_lens, np.int32),
                row_starts=row_starts, row_slot=row_slot, row_pos=row_pos,
                w_max=int(max(q_lens)))


def _live_rows(b):
    for s, n in enumerate(b["q_lens"]):
        s0 = int(b["row_starts"][s])
        yield s, slice(s0, s0 + int(n))


def _port_plain(b):
    return rpa.ragged_paged_attention(
        _t(b["q"]), _t(b["kp"]), _t(b["vp"]), _t(b["tables"]),
        _t(b["ctx"]), _t(b["q_lens"]), _t(b["row_starts"]), b["w_max"]).numpy()


def _jax_kernel(b):
    out = jpa.pallas_ragged_paged_attention(
        jnp.asarray(b["q"]), jnp.asarray(b["kp"]), jnp.asarray(b["vp"]),
        jnp.asarray(b["tables"]), jnp.asarray(b["ctx"]),
        jnp.asarray(b["q_lens"]), jnp.asarray(b["row_starts"]),
        w_max=b["w_max"], interpret=True)
    return np.asarray(out)


def test_row_meta_matches_reference():
    args = ([1, 3, 0, 5], [10, 4, 0, 0], 12, 999)
    for a, b in zip(tpc.ragged_row_meta(*args), jpc.ragged_row_meta(*args)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="row budget"):
        tpc.ragged_row_meta([7, 7], [0, 0], 12, 999)


def test_allocator_lifo_and_leak_sweep():
    a = tpc.BlockAllocator(6)
    ref = jpc.BlockAllocator(6)
    assert a.alloc(2) == ref.alloc(2)
    assert a.alloc(1) == ref.alloc(1)
    a.free([1])
    ref.free([1])
    assert a.alloc(2) == ref.alloc(2)
    a.check_leaks([2, 3, 1, 4])
    with pytest.raises(ValueError, match="double free"):
        a.free([5])
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc(2)
    assert tpc.blocks_for(17, 8) == jpc.blocks_for(17, 8) == 3


def test_write_rows_matches_reference_and_null_routes():
    """Same K/V rows scattered by both packages: the live blocks are
    identical, and the pad rows (overflow position) touched only the
    null block."""
    rng = np.random.RandomState(3)
    S, T, H, D, BS, MB = 2, 4, 2, 4, 4, 3
    tables = (1 + np.arange(S * MB, dtype=np.int32)).reshape(S, MB)
    row_slot, row_pos, _, _ = tpc.ragged_row_meta([T, T], [3, 6],
                                                  2 * T + 2, MB * BS)
    k = rng.randn(2 * T + 2, H, D).astype(np.float32)
    v = rng.randn(2 * T + 2, H, D).astype(np.float32)
    jk, jv = jpc.init_pool(1 + S * MB, BS, H, D, jnp.float32)
    jk, jv = jpc.write_rows(jk, jv, jnp.asarray(tables),
                            jnp.asarray(row_slot), jnp.asarray(row_pos),
                            jnp.asarray(k), jnp.asarray(v))
    tk, tv = tpc.init_pool(1 + S * MB, BS, H, D, torch.float32, "cpu")
    tpc.write_rows(tk, tv, _t(tables), _t(row_slot), _t(row_pos), _t(k),
                   _t(v))
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
    assert tk.numpy()[0].any()


def test_plain_ragged_matches_interpreted_kernel_mixed_batch():
    """The reference test's mixed batch: a decode row, a verify-width
    window, a chunk starting at a block edge and a zero-row slot."""
    rng = np.random.RandomState(1)
    b = _batch(rng, base=[5, 15, 0, 24], q_lens=[1, 3, 0, 8], H=8, Hkv=4,
               D=64, BS=8, MB=6, extra_rows=4)
    got, want = _port_plain(b), _jax_kernel(b)
    for s, rows in _live_rows(b):
        np.testing.assert_allclose(got[rows], want[rows], **TOL,
                                   err_msg=f"slot {s}")


@pytest.mark.parametrize("block_size", [8, 16])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("lens_seed", [0, 1])
def test_plain_ragged_matches_interpreted_kernel_shapes(block_size, rep,
                                                        lens_seed):
    """Block size, GQA group width and slot lengths varied: random cache
    lengths, one slot carrying a multi-block chunk, the others 0..3
    rows."""
    rng = np.random.RandomState(100 + 10 * block_size + rep + lens_seed)
    S, MB = 4, 5
    q_lens = list(rng.randint(0, 4, size=S))
    q_lens[int(rng.randint(S))] = int(rng.randint(4, 2 * block_size))
    base = [int(rng.randint(0, MB * block_size - n)) for n in q_lens]
    b = _batch(rng, base, q_lens, H=2 * rep, Hkv=2, D=64, BS=block_size,
               MB=MB)
    got, want = _port_plain(b), _jax_kernel(b)
    for s, rows in _live_rows(b):
        np.testing.assert_allclose(got[rows], want[rows], **TOL,
                                   err_msg=f"slot {s}")


def test_attention_step_writes_then_attends():
    """The port's ragged_attention_step (write rows, attend with
    cache_lens + 1) equals the reference's write_rows followed by the
    interpreted kernel, and leaves the pools as the reference's."""
    rng = np.random.RandomState(7)
    b = _batch(rng, base=[9, 0, 30], q_lens=[1, 12, 2], H=4, Hkv=2, D=64,
               BS=8, MB=6)
    R = b["q"].shape[0]
    kh = rng.randn(R, 2, 64).astype(np.float32)
    vh = rng.randn(R, 2, 64).astype(np.float32)
    cache_lens = b["ctx"] - 1
    kp, vp = _t(b["kp"]), _t(b["vp"])
    out, kp2, vp2 = tpa.ragged_attention_step(
        _t(b["q"]), _t(kh), _t(vh), kp, vp, _t(b["tables"]),
        _t(cache_lens), _t(b["q_lens"]), _t(b["row_starts"]),
        _t(b["row_slot"]), _t(b["row_pos"]), b["w_max"])
    jk, jv = jpc.write_rows(
        jnp.asarray(b["kp"]), jnp.asarray(b["vp"]), jnp.asarray(b["tables"]),
        jnp.asarray(b["row_slot"]), jnp.asarray(b["row_pos"]),
        jnp.asarray(kh), jnp.asarray(vh))
    np.testing.assert_array_equal(kp2.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(vp2.numpy()[1:], np.asarray(jv)[1:])
    want = _jax_kernel(dict(b, kp=np.asarray(jk), vp=np.asarray(jv)))
    for s, rows in _live_rows(b):
        np.testing.assert_allclose(out.numpy()[rows], want[rows], **TOL)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(2)
    b = _batch(rng, base=[3, 8], q_lens=[1, 4], H=4, Hkv=2, D=64)
    n0 = launch_counts["ragged_paged_attention"]
    _port_plain(b)
    assert launch_counts["ragged_paged_attention"] == n0


def test_wrapper_raises_on_backward_with_grad_enabled():
    """K2r has no backward: with gradients enabled on a query that
    requires them, ``backward()`` raises naming the kernel."""
    rng = np.random.RandomState(3)
    b = _batch(rng, base=[3, 8], q_lens=[1, 4], H=4, Hkv=2, D=64)
    q = _t(b["q"]).requires_grad_()
    out = rpa.ragged_paged_attention(
        q, _t(b["kp"]), _t(b["vp"]), _t(b["tables"]), _t(b["ctx"]),
        _t(b["q_lens"]), _t(b["row_starts"]), b["w_max"])
    with pytest.raises(NotImplementedError, match="ragged_paged_attention"):
        out.sum().backward()


@pytest.mark.parametrize("rep,block_size", [(1, 8), (4, 16), (7, 16)])
def test_plain_ragged_matches_interpreted_kernel_bf16(rep, block_size):
    """bfloat16 pools and rows (the serving dtype): the plain K2r against
    the interpreted kernel at atol = rtol = 2e-2 (both round the output
    to bfloat16, the kernel also P before P @ V; N(0, 1) inputs differ by
    about one bfloat16 ulp of the output). A decode row, a window, a
    multi-block chunk and a zero-row slot; GQA groups 1, 4 and 7."""
    rng = np.random.RandomState(40 + rep)
    b = _batch(rng, base=[5, 15, 0, 24], q_lens=[1, 3, 0, 12], H=2 * rep,
               Hkv=2, D=64, BS=block_size, MB=6, extra_rows=2)
    bf = {k: (b[k].astype(jnp.bfloat16) if k in ("q", "kp", "vp")
              else b[k]) for k in b}
    want = np.asarray(_jax_kernel(bf)).astype(np.float32)
    got = rpa.ragged_paged_attention(
        _t(b["q"], torch.bfloat16), _t(b["kp"], torch.bfloat16),
        _t(b["vp"], torch.bfloat16), _t(b["tables"]), _t(b["ctx"]),
        _t(b["q_lens"]), _t(b["row_starts"]), b["w_max"])
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for s, rows in _live_rows(b):
        np.testing.assert_allclose(got[rows], want[rows], rtol=2e-2,
                                   atol=2e-2, err_msg=f"slot {s}")


@pytest.mark.parametrize("slots,kv_heads,rep,w_max,d,sms,want", [
    (8, 8, 4, 128, 128, 132, (264, 264 * 64 * 130, 64)),
    (8, 8, 4, 1, 128, 132, (264, 264 * 4 * 130, 64)),
    (4, 4, 7, 5, 128, 132, (264, 264 * 35 * 130, 16)),
    (2, 16, 1, 300, 64, 114, (228, 228 * 64 * 66, 32)),
    (3, 1, 64, 9, 64, 1, (2, 2 * 64 * 66, 3))])
def test_sm90_scratch_sizes(slots, kv_heads, rep, w_max, d, sms, want):
    """The bfloat16 body's scratch: a split record a block of one wave
    (two blocks an SM), each (m, l, o) of min(64 // rep, w_max) * rep
    query vectors, and an arrival counter a (slot, kv head)."""
    assert rpa.sm90_scratch_sizes(slots, kv_heads, rep, w_max, d,
                                  sms) == want


@pytest.mark.parametrize("source", ["ragged_paged_attention.cu",
                                    "paged_decode_attention.cu"])
def test_f32_pools_route_to_the_hopper_body(source):
    """A bfloat16 q over float32 pools (dtype code 2) launches the Hopper
    body's f32 instance: the C entries send it to ``pa90::launch`` with
    ``f32`` set, and no FMA body is instantiated for a bfloat16 q."""
    from pathlib import Path
    import paddle_tpu_torch
    src = (Path(paddle_tpu_torch.__file__).parent / "csrc"
           / source).read_text()
    assert "__nv_bfloat16, float>" not in src
    assert "if (dtype == 1 || dtype == 2)" in src
    assert "pa90::launch(q, kp, vp, ksf, vsf, dtype == 2," in src


@pytest.mark.parametrize("code,d,blocks", [(1, 64, 2), (1, 128, 2),
                                           (2, 64, 2), (2, 128, 1)])
def test_sm90_blocks_per_sm(code, d, blocks):
    """The Hopper body's blocks an SM per instance (its Cfg::BLOCKS): one
    for float32 pools at head_dim 128, whose 64 KB stages leave room for
    one block, two otherwise; the split records are a wave of them."""
    assert rpa.F32_POOL == 2
    assert rpa.sm90_blocks_per_sm(code, d) == blocks
    assert rpa.sm90_scratch_sizes(4, 16, 1, 1, d, 132,
                                  rpa.sm90_blocks_per_sm(code, d)) == \
        (blocks * 132, blocks * 132 * (d + 2), 64)
