"""The PyTorch port's MoE grouped matmuls (K4's modes, K5's gmm, d(lhs)
and tgmm) and dispatch, forward and backward, against the JAX package on
the CPU.

Kernel level: the port's plain ``gather_gmm_swiglu``, ``scatter_gmm``
and ``gather_gmm`` (with and without ``src_rows``, and the transposed
modes of the backward) against the reference's Pallas kernel run in
interpret mode, at s 64, d 64, f 128, e 8, top-2, over three routings:
random picks, picks that leave most experts empty, and a 16-row tiling
under which groups start mid-tile; the plain ``tgmm`` and transposed
gmm on sorted rows against megablox ``tgmm`` / ``gmm(transpose_rhs=True)``
interpreted, with an empty group and a group of one row, and again at
the uneven group sizes of the GPU tests' tile edges; the plain forward
modes against the Pallas kernel interpreted at those group sizes and at
the same edges around 128-row tiles. Tolerances:
1e-5 in float32 (the same products summed in another order), 2e-2 in
bfloat16 (one rounding of the output to bf16 either way).

Dispatch level: ``moe_dispatch_combine_dropless`` and
``moe_dispatch_combine_grouped`` (capacity 1.25) against the
reference's CPU sorted path, ``y`` and ``aux`` within 1e-5 in float32,
and the four gradients (x, gate_up, down, router logits) against
``jax.grad`` of the reference on both of the port's paths, each divided
by ``max(|ref|, 1)``, within 2e-5 (the reference's own bar for its
fused VJP); ``_FusedMoeCore``'s backward against the reference's
``_fused_moe_core`` VJP with the Pallas kernels interpreted; the sorted
path's graph holds the ``_Gmm`` node; the port's fused and sorted paths
agree; a router tie goes to the lower expert index as ``lax.top_k``;
nothing in the dispatch or its backwards reads a value to the host; the
options of later slices raise.
"""
import importlib
import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import moe as JM
from paddle_tpu.ops.pallas.flash_attention_kernel import disable_x64
from paddle_tpu.ops.pallas import moe_gmm as JG
from paddle_tpu_torch.distributed import moe as TM
from paddle_tpu_torch.ops.kernels import moe_gmm as TG

S, D, F, E, K = 64, 64, 128, 8, 2
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = 2e-5         # dispatch gradients over max(|ref|, 1)
MB = importlib.import_module("jax.experimental.pallas.ops.tpu.megablox.gmm")


def _routing(kind, rng):
    """``(order, src_rows, counts)`` of a stable expert-major sort of
    top-2 picks, as the dispatch derives them."""
    if kind == "sparse":            # five of eight experts empty
        flat_e = rng.choice([0, 3, 7], S * K).astype(np.int32)
    else:
        flat_e = rng.randint(0, E, S * K).astype(np.int32)
    order = np.argsort(flat_e, kind="stable").astype(np.int32)
    counts = np.bincount(flat_e, minlength=E).astype(np.int32)
    return order, (order // K).astype(np.int32), counts


def _both(a, dtype):
    """``a`` as a jax array and a torch tensor of the same dtype."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(
        getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routing,tiling", [
    ("random", None), ("sparse", None), ("random", (16, 64, 64))])
def test_plain_modes_match_interpreted_pallas(dtype, routing, tiling):
    rng = np.random.RandomState(0)
    xj, xt = _both(rng.randn(S, D), dtype)
    guj, gut = _both(0.1 * rng.randn(E, D, 2 * F), dtype)
    dnj, dnt = _both(0.1 * rng.randn(E, F, D), dtype)
    order, src, counts = _routing(routing, rng)
    gsj, gst = jnp.asarray(counts), torch.from_numpy(counts)
    srcj, srct = jnp.asarray(src), torch.from_numpy(src)
    ordj, ordt = jnp.asarray(order), torch.from_numpy(order)
    kw = dict(interpret=True)
    if tiling is not None:
        kw["tiling"] = tiling

    h_ref = JG.gather_gmm_swiglu(xj, srcj, guj, gsj, **kw)
    h = TG.gather_gmm_swiglu(xt, srct, gut, gst)
    _close(h, h_ref, dtype)
    # the scatter mode takes the same h on both sides
    hj, ht = _both(np.asarray(h_ref, np.float32), dtype)
    ys = TG.scatter_gmm(ht, dnt, gst, ordt)
    _close(ys, JG.scatter_gmm(hj, dnj, gsj, ordj, **kw), dtype)
    # the plain gather (no epilogue) and K5's gmm on sorted rows
    _close(TG.gather_gmm(xt, srct, gut, gst),
           JG.gather_gmm(xj, srcj, guj, gsj, **kw), dtype)
    xsj, xst = jnp.take(xj, srcj, axis=0), xt[srct.long()]
    _close(TG.gather_gmm(xst, None, gut, gst),
           JG.gather_gmm(xsj, None, guj, gsj, **kw), dtype)


def test_rows_past_the_groups_are_zero_and_transpose_raises():
    """Rows no group owns come out zero, in the forward and in the
    transposed modes; tgmm never reads them. (The name is kept from the
    slice whose transposed modes raised; they now run.)"""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(10, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 16, 8).astype(np.float32))
    gs = torch.tensor([2, 0, 5], dtype=torch.int32)      # 7 of 10 rows
    out = TG.gather_gmm(x, None, w, gs)
    np.testing.assert_allclose(out[:2].numpy(), (x[:2] @ w[0]).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out[2:7].numpy(), (x[2:7] @ w[2]).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not out[7:].any()
    wt = w.transpose(1, 2).contiguous()                  # [e, N, K]
    out_t = TG.gather_gmm(x, None, wt, gs, transpose_rhs=True)
    np.testing.assert_array_equal(out_t.numpy(), out.numpy())
    dst = torch.from_numpy(rng.permutation(10).astype(np.int32))
    out_s = TG.scatter_gmm(x, wt, gs, dst, transpose_rhs=True)
    np.testing.assert_array_equal(out_s[dst.long()].numpy(), out.numpy())
    assert not out_s[dst[7:].long()].any()
    dy = torch.from_numpy(rng.randn(10, 8).astype(np.float32))
    x_nan, dy_nan = x.clone(), dy.clone()
    x_nan[7:], dy_nan[7:] = float("nan"), float("nan")
    dw = TG.tgmm(x_nan, dy_nan, gs, 3)
    np.testing.assert_allclose(dw[0].numpy(), (x[:2].T @ dy[:2]).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dw[2].numpy(), (x[2:7].T @ dy[2:7]).numpy(),
                               rtol=1e-6, atol=1e-5)
    assert not dw[1].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routing", ["random", "sparse"])
def test_plain_transposed_modes_match_interpreted_pallas(dtype, routing):
    """The backward's K4 modes: ``dh = gather_gmm(dpair, order, down,
    transpose_rhs=True)`` (and the same on pre-sorted rows, K5's d(lhs))
    and ``dx_tok = scatter_gmm(dgu, gate_up, order, transpose_rhs=True)``
    against the Pallas kernel interpreted."""
    rng = np.random.RandomState(2)
    guj, gut = _both(0.1 * rng.randn(E, D, 2 * F), dtype)
    dnj, dnt = _both(0.1 * rng.randn(E, F, D), dtype)
    dpj, dpt = _both(rng.randn(S * K, D), dtype)
    dguj, dgut = _both(rng.randn(S * K, 2 * F), dtype)
    order, _, counts = _routing(routing, rng)
    gsj, gst = jnp.asarray(counts), torch.from_numpy(counts)
    ordj, ordt = jnp.asarray(order), torch.from_numpy(order)
    kw = dict(interpret=True, transpose_rhs=True)
    _close(TG.gather_gmm(dpt, ordt, dnt, gst, transpose_rhs=True),
           JG.gather_gmm(dpj, ordj, dnj, gsj, **kw), dtype)
    dsj, dst = jnp.take(dpj, ordj, axis=0), dpt[ordt.long()]
    _close(TG.gather_gmm(dst, None, dnt, gst, transpose_rhs=True),
           JG.gather_gmm(dsj, None, dnj, gsj, **kw), dtype)
    _close(TG.scatter_gmm(dgut, gut, gst, ordt, transpose_rhs=True),
           JG.scatter_gmm(dguj, guj, gsj, ordj, **kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_tgmm_and_dlhs_match_megablox(dtype):
    """K5's backward kernels: the plain ``tgmm`` against megablox
    ``tgmm(lhs.T, dy, gs, num_actual_groups=e)`` and the plain transposed
    gmm on sorted rows against megablox ``gmm(transpose_rhs=True)``,
    both interpreted, with an empty group and a group of one row."""
    rng = np.random.RandomState(3)
    m, k, n = S * K, D, 2 * F
    counts = np.array([30, 0, 1, 40, 17, 0, 20, 20], np.int32)
    lj, lt = _both(rng.randn(m, k), dtype)
    yj, yt = _both(rng.randn(m, n), dtype)
    wj, wt = _both(0.1 * rng.randn(E, k, n), dtype)   # [e, N, K]
    gsj, gst = jnp.asarray(counts), torch.from_numpy(counts)
    kw = dict(preferred_element_type=jnp.dtype(dtype), tiling=(16, 64, 128),
              interpret=True)
    got = TG.tgmm(lt, yt, gst, E)
    assert got.dtype == getattr(torch, dtype) and not got[[1, 5]].any()
    with disable_x64():         # megablox traces in 32-bit mode
        want = MB.tgmm(lj.T, yj, gsj, num_actual_groups=E, **kw)
        want_t = MB.gmm(yj, wj, gsj, transpose_rhs=True, **kw)
    _close(got, want, dtype)
    _close(TG.gather_gmm(yt, None, wt, gst, transpose_rhs=True), want_t,
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_at_uneven_groups_matches_megablox(dtype):
    """The plain ``tgmm`` and transposed gmm on sorted rows against
    megablox interpreted at the group sizes the GPU tests cross the
    kernels' tile edges with: 1, 63, 64, 65, 0, 127, 129 and 257 rows
    (starts off every tile boundary, an empty and a one-row group, each
    group between non-empty neighbours), and 14 more to fill 720 rows."""
    rng = np.random.RandomState(4)
    counts = np.array([1, 63, 64, 65, 0, 127, 129, 257, 14], np.int32)
    e, m, k, n = counts.size, int(counts.sum()), 64, 128
    lj, lt = _both(rng.randn(m, k), dtype)
    yj, yt = _both(rng.randn(m, n), dtype)
    wj, wt = _both(0.1 * rng.randn(e, k, n), dtype)   # [e, N, K]
    gsj, gst = jnp.asarray(counts), torch.from_numpy(counts)
    kw = dict(preferred_element_type=jnp.dtype(dtype), tiling=(16, 64, 128),
              interpret=True)
    got = TG.tgmm(lt, yt, gst, e)
    assert not got[4].any()
    with disable_x64():         # megablox traces in 32-bit mode
        want = MB.tgmm(lj.T, yj, gsj, num_actual_groups=e, **kw)
        want_t = MB.gmm(yj, wj, gsj, transpose_rhs=True, **kw)
    _close(got, want, dtype)
    _close(TG.gather_gmm(yt, None, wt, gst, transpose_rhs=True), want_t,
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("counts,d,f", [
    ((1, 63, 64, 65, 0, 127, 129, 257, 14), 64, 96),
    ((1, 127, 128, 129, 0, 255, 257, 513), 64, 96)])
def test_plain_forward_at_uneven_groups_matches_interpreted_pallas(
        dtype, counts, d, f):
    """The plain forward modes (gather + swiglu, scatter, the plain
    gather and K5's gmm on sorted rows) against the Pallas kernel
    interpreted, at the group sizes the GPU tests cross both CUDA bodies'
    tile edges with: 1, 63, 64, 65, 0, 127, 129 and 257 rows (and 14 to
    fill 720), and the same edges around 128-row tiles; each group
    between non-empty neighbours, the rows in a random order. (The
    ragged widths the GPU tests add, K 72 and f 136, cost the
    interpreter minutes and change nothing in the plain versions.)"""
    rng = np.random.RandomState(5)
    counts = np.asarray(counts, np.int32)
    e, m = counts.size, int(counts.sum())
    flat = rng.permutation(np.repeat(np.arange(e), counts))
    order = np.argsort(flat, kind="stable").astype(np.int32)
    xj, xt = _both(rng.randn(m, d), dtype)
    guj, gut = _both(0.1 * rng.randn(e, d, 2 * f), dtype)
    dnj, dnt = _both(0.1 * rng.randn(e, f, d), dtype)
    gsj, gst = jnp.asarray(counts), torch.from_numpy(counts)
    ordj, ordt = jnp.asarray(order), torch.from_numpy(order)
    h_ref = JG.gather_gmm_swiglu(xj, ordj, guj, gsj, interpret=True)
    _close(TG.plain_gather_gmm_swiglu(xt, ordt, gut, gst), h_ref, dtype)
    hj, ht = _both(np.asarray(h_ref, np.float32), dtype)
    _close(TG.plain_scatter_gmm(ht, dnt, gst, ordt),
           JG.scatter_gmm(hj, dnj, gsj, ordj, interpret=True), dtype)
    _close(TG.plain_gather_gmm(xt, ordt, gut, gst),
           JG.gather_gmm(xj, ordj, guj, gsj, interpret=True), dtype)
    xsj, xst = jnp.take(xj, ordj, axis=0), xt[ordt.long()]
    _close(TG.plain_gather_gmm(xst, None, gut, gst),
           JG.gather_gmm(xsj, None, guj, gsj, interpret=True), dtype)


# ------------------------------------------------------------- dispatch

def _dispatch_case(seed, s=48, d=32, f=48, e=8, skew=0.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(s, d).astype(np.float32)
    logits = rng.randn(s, e).astype(np.float32)
    logits[:, 0] += skew                # crowd expert 0 past its capacity
    gu = (0.1 * rng.randn(e, d, 2 * f)).astype(np.float32)
    dn = (0.1 * rng.randn(e, f, d)).astype(np.float32)
    return x, logits, gu, dn


@pytest.mark.parametrize("kind", ["dropless", "grouped"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_dispatch_matches_reference(kind, normalize, fused):
    x, logits, gu, dn = _dispatch_case(3, skew=2.0)
    e, k = 8, 2
    jfn = getattr(JM, f"moe_dispatch_combine_{kind}")
    tfn = getattr(TM, f"moe_dispatch_combine_{kind}")
    extra = {} if kind == "dropless" else dict(capacity_factor=1.25)
    y_ref, aux_ref, st_ref = jfn(*map(jnp.asarray, (x, logits)), e, k,
                                 jnp.asarray(gu), jnp.asarray(dn),
                                 normalize_gates=normalize,
                                 return_stats=True, **extra)
    y, aux, st = tfn(*map(torch.from_numpy, (x, logits)), e, k,
                     torch.from_numpy(gu), torch.from_numpy(dn),
                     normalize_gates=normalize, return_stats=True,
                     fused=fused, **extra)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)
    np.testing.assert_allclose(float(st["drop_rate"]),
                               float(st_ref["drop_rate"]), atol=1e-7)
    if kind == "grouped":       # the skew makes capacity bite
        assert float(st["drop_rate"]) > 0
    want = "fused_gmm" if fused else "gmm"
    assert TM.moe_stats()["grouped_mm_kernel"] == want


def test_fused_and_sorted_paths_agree():
    x, logits, gu, dn = (torch.from_numpy(a) for a in _dispatch_case(4))
    TM.reset_moe_stats()
    y1, a1 = TM.moe_dispatch_combine_dropless(x, logits, 8, 2, gu, dn)
    y2, a2 = TM.moe_dispatch_combine_dropless(x, logits, 8, 2, gu, dn,
                                              fused=False)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-6,
                               rtol=1e-6)
    assert float(a1) == float(a2)
    assert TM.moe_stats()["grouped_mm_calls"] == 4


def test_router_tie_goes_to_the_lower_expert():
    """Equal probabilities: ``lax.top_k`` keeps the lower index first;
    a bare ``torch.topk`` need not."""
    logits = np.zeros((6, 8), np.float32)
    logits[:, [2, 5, 6]] = 1.0              # a three-way tie for top-2
    logits[3, :] = 0.5                      # a full tie
    probs = torch.softmax(torch.from_numpy(logits), -1)
    _, idx = TM._top_k(probs, 2)
    _, idx_ref = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    # and the dispatch built on it matches the reference's output
    x, _, gu, dn = _dispatch_case(5, s=6)
    y_ref, _ = JM.moe_dispatch_combine_dropless(
        jnp.asarray(x), jnp.asarray(logits), 8, 2, jnp.asarray(gu),
        jnp.asarray(dn))
    y, _ = TM.moe_dispatch_combine_dropless(
        torch.from_numpy(x), torch.from_numpy(logits), 8, 2,
        torch.from_numpy(gu), torch.from_numpy(dn))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5,
                               rtol=1e-5)


def test_serving_tap_collects_device_counts():
    x, logits, gu, dn = (torch.from_numpy(a) for a in _dispatch_case(6))
    sink = []
    with TM.serving_stats_tap(sink):
        TM.moe_dispatch_combine_dropless(x, logits, 8, 2, gu, dn)
    TM.moe_dispatch_combine_dropless(x, logits, 8, 2, gu, dn)
    assert len(sink) == 1 and sink[0].dtype == torch.int32
    top2 = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                      stable=True).indices[:, :2].reshape(-1)
    np.testing.assert_array_equal(
        sink[0].numpy(), np.bincount(top2.numpy(), minlength=8))


def _graph_nodes(t):
    """Names of the autograd nodes behind ``t``."""
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        names.add(type(n).__name__)
        stack += [m for m, _ in n.next_functions]
    return names


@pytest.mark.parametrize("kind", ["dropless", "grouped"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_dispatch_gradients_match_jax_grad(kind, normalize, fused):
    """d(x), d(gate_up), d(down) and d(router logits) of ``sum(y * y) +
    aux`` against ``jax.grad`` of the reference; the skew drops pairs
    under capacity 1.25."""
    x, logits, gu, dn = _dispatch_case(3, skew=2.0)
    e, k = 8, 2
    jfn = getattr(JM, f"moe_dispatch_combine_{kind}")
    tfn = getattr(TM, f"moe_dispatch_combine_{kind}")
    extra = {} if kind == "dropless" else dict(capacity_factor=1.25)

    def loss_ref(x, logits, gu, dn):
        y, aux = jfn(x, logits, e, k, gu, dn, normalize_gates=normalize,
                     **extra)
        return jnp.sum(y * y) + aux

    want = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, logits, gu, dn)))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, logits, gu, dn)]
    y, aux = tfn(leaves[0], leaves[1], e, k, leaves[2], leaves[3],
                 normalize_gates=normalize, fused=fused, **extra)
    assert ("_FusedMoeCoreBackward" if fused else "_GmmBackward") \
        in _graph_nodes(y)
    ((y * y).sum() + aux).backward()
    for name, t, w in zip(("dx", "dlogits", "dgate_up", "ddown"), leaves,
                          want):
        scale = max(float(jnp.abs(w).max()), 1.0)
        np.testing.assert_allclose(t.grad.numpy() / scale,
                                   np.asarray(w) / scale, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_fused_core_backward_matches_reference_vjp():
    """``_FusedMoeCore``'s backward against the reference's
    ``_fused_moe_core`` VJP with its Pallas kernels interpreted (the
    reference runs them at 128-aligned shapes): d(x), d(gate_up),
    d(down) and d(gates) for one cotangent."""
    rng = np.random.RandomState(4)
    s, d, f, e, k = 128, 128, 128, 8, 2
    x = rng.randn(s, d).astype(np.float32)
    gu = (0.1 * rng.randn(e, d, 2 * f)).astype(np.float32)
    dn = (0.1 * rng.randn(e, f, d)).astype(np.float32)
    gates = rng.rand(s, k).astype(np.float32)
    dy = rng.randn(s, d).astype(np.float32)
    flat = rng.randint(0, e, s * k)
    flat[:40] = 2                             # one crowded expert
    flat[flat == 5] = 6                       # and an empty one
    order = np.argsort(flat, kind="stable").astype(np.int32)
    src = (order // k).astype(np.int32)
    gs = np.bincount(flat, minlength=e).astype(np.int32)
    y_ref, vjp = jax.vjp(
        lambda *a: JM._fused_moe_core(k, True, *a, jnp.asarray(order),
                                      jnp.asarray(src), jnp.asarray(gs)),
        *map(jnp.asarray, (x, gu, dn, gates)))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, gu, dn,
                                                             gates)]
    y = TM._FusedMoeCore.apply(*leaves, torch.from_numpy(order),
                               torch.from_numpy(src), torch.from_numpy(gs),
                               k)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=1e-5, rtol=1e-5)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for name, a, b in zip(("dx", "dgate_up", "ddown", "dgates"), got,
                          want):
        scale = max(float(jnp.abs(b).max()), 1.0)
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale,
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    assert not got[1][5].any() and not got[2][5].any()


def test_dispatch_reads_nothing_back_to_the_host():
    """The routing stays on the device: no call in the dispatch, nor in
    the backwards of ``_FusedMoeCore`` and ``_Gmm``, reads a value back
    (``item``, ``tolist``, ``bincount``, ``nonzero``,
    ``repeat_interleave``) or indexes with a boolean mask."""
    banned = {"item", "tolist", "bincount", "nonzero", "repeat_interleave",
              "masked_select", "numpy", "cpu", "one_hot"}
    for obj in (TM, TM._FusedMoeCore, TM._Gmm, TM._grouped_mm_dlhs,
                TM._grouped_mm_drhs):
        tree = ast.parse(inspect.getsource(obj).lstrip()
                         if obj is not TM else inspect.getsource(obj))
        calls = {getattr(n.func, "attr", getattr(n.func, "id", None))
                 for n in ast.walk(tree) if isinstance(n, ast.Call)}
        assert not calls & banned, (obj, calls & banned)
    backward = ast.parse(inspect.getsource(TM._FusedMoeCore))
    assert any(isinstance(n, ast.FunctionDef) and n.name == "backward"
               for n in ast.walk(backward))


def test_kernel_wrappers_without_backward_raise_on_backward():
    """Called directly with gradients enabled on an input that requires
    them, a K4 / K5 wrapper's output carries a node whose backward
    raises naming the kernel; under ``no_grad`` it carries none."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(6, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 8, 16).astype(np.float32)) \
        .requires_grad_()
    gs = torch.tensor([4, 2], dtype=torch.int32)
    rows = torch.arange(6, dtype=torch.int32)
    calls = {"moe_gmm": lambda: TG.gather_gmm(x, rows, w, gs),
             "moe_gather_gmm_swiglu": lambda: TG.gather_gmm_swiglu(
                 x, None, w, gs),
             "moe_scatter_gmm": lambda: TG.scatter_gmm(x, w, gs, rows),
             "moe_tgmm": lambda: TG.tgmm(x, w[0, :6], gs, 2)}
    for name, call in calls.items():
        out = call()
        with pytest.raises(NotImplementedError, match=name):
            out.sum().backward()
        with torch.no_grad():
            plain = call()
        assert plain.grad_fn is None
        np.testing.assert_array_equal(out.detach().numpy(), plain.numpy())


def test_later_slice_options_raise():
    """Random second-expert routing and the padded dispatch still raise
    (now naming the slice that brings them); the backward, which raised
    before this slice, runs."""
    x, logits, gu, dn = (torch.from_numpy(a) for a in _dispatch_case(7))
    with pytest.raises(NotImplementedError,
                       match="expert parallelism and gates"):
        TM.moe_dispatch_combine_grouped(
            x, logits, 8, 2, gu, dn, second_expert_policy="random",
            rng_key=0)
    with pytest.raises(NotImplementedError,
                       match="expert parallelism and gates"):
        TM.moe_dispatch_combine(x, logits, 8, expert_fn=lambda t: t)
    xg = x.clone().requires_grad_()
    y, _ = TM.moe_dispatch_combine_dropless(xg, logits, 8, 2, gu, dn)
    y.sum().backward()
    assert xg.grad.shape == x.shape and torch.isfinite(xg.grad).all()
    assert xg.grad.abs().sum() > 0
