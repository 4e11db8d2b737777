"""The PyTorch port's MoE grouped matmuls (K4's forward modes, K5's
forward gmm) and dispatch against the JAX package on the CPU.

Kernel level: the port's plain ``gather_gmm_swiglu``, ``scatter_gmm``
and ``gather_gmm`` (with and without ``src_rows``) against the
reference's Pallas kernel run in interpret mode, at s 64, d 64, f 128,
e 8, top-2, over three routings: random picks, picks that leave most
experts empty, and a 16-row tiling under which groups start mid-tile.
Tolerances: 1e-5 in float32 (the same products summed in another
order), 2e-2 in bfloat16 (one rounding of the output to bf16 either
way).

Dispatch level: ``moe_dispatch_combine_dropless`` and
``moe_dispatch_combine_grouped`` (capacity 1.25) against the
reference's CPU sorted path, ``y`` and ``aux`` within 1e-5 in float32;
the port's fused and sorted paths agree; a router tie goes to the lower
expert index as ``lax.top_k``; the options of later slices raise.
"""
import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import moe as JM
from paddle_tpu.ops.pallas import moe_gmm as JG
from paddle_tpu_torch.distributed import moe as TM
from paddle_tpu_torch.ops.kernels import moe_gmm as TG

S, D, F, E, K = 64, 64, 128, 8, 2
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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
    with pytest.raises(NotImplementedError, match="MoE training"):
        TG.gather_gmm(x, None, w, gs, transpose_rhs=True)
    with pytest.raises(NotImplementedError, match="MoE training"):
        TG.scatter_gmm(x, w, gs, torch.arange(10, dtype=torch.int32),
                       transpose_rhs=True)


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


def test_dispatch_reads_nothing_back_to_the_host():
    """The routing stays on the device: no call in the dispatch reads a
    value back (``item``, ``tolist``, ``bincount``, ``nonzero``,
    ``repeat_interleave``) or indexes with a boolean mask."""
    tree = ast.parse(inspect.getsource(TM))
    calls = {getattr(n.func, "attr", getattr(n.func, "id", None))
             for n in ast.walk(tree) if isinstance(n, ast.Call)}
    assert not calls & {"item", "tolist", "bincount", "nonzero",
                        "repeat_interleave", "masked_select", "numpy",
                        "cpu", "one_hot"}


def test_later_slice_options_raise():
    x, logits, gu, dn = (torch.from_numpy(a) for a in _dispatch_case(7))
    with pytest.raises(NotImplementedError, match="MoE training"):
        TM.moe_dispatch_combine_grouped(
            x, logits, 8, 2, gu, dn, second_expert_policy="random",
            rng_key=0)
    with pytest.raises(NotImplementedError, match="MoE training"):
        TM.moe_dispatch_combine(x, logits, 8, expert_fn=lambda t: t)
    xg = x.clone().requires_grad_()
    y, _ = TM.moe_dispatch_combine_dropless(xg, logits, 8, 2, gu, dn)
    with pytest.raises(NotImplementedError, match="MoE training"):
        y.sum().backward()
