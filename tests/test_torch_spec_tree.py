"""The PyTorch port's token-tree speculation against the JAX package on the
CPU.

The tree helpers (``tree_ancestor_bits``, ``ngram_propose_topk``,
``tree_chain_layout``, ``tree_fill_from_chains``) must give the
reference's outputs and refuse what it refuses. The plain K2v tree mode
must match the reference's interpreted Pallas kernel
(``pallas_paged_verify_attention(tree_anc=)``) and its gather fallback
(``_xla_paged_verify(tree_anc=)``) at rtol = atol = 1e-5 in float32 and on
int8 pools (one softmax a row over the same float32 scores, summed in
another order), and at 2e-2 in bfloat16 (the existing K2v bf16 parity
tolerance: both round P and the output to bfloat16), over GQA groups 1 and
2 and block sizes 8 and 16; a chain tree's output equals linear K2v bit
for bit. Greedy tree acceptance and ``permute_window`` (float32 and int8
pools, data and scales) equal the reference's exactly; the sampled rule
emits the filtered target distribution (chi-square; the RNG streams of the
packages differ). One tree verify step on the reference's tiny Llama
matches the reference's tokens and pools (1e-5), with a branch node
accepted and with a whole chain; its pools are the window's rows moved by
the accepted path, bit for bit, and where rope positions allow (every
layer for a chain, layer 0's V off the spine) those of sequential
decoding (1e-5: the same per-token products in another batch shape).
Greedy ``generate(spec_tree=)`` gives the reference's tokens (scores
within 1e-4), and a chain tree the port's linear n-gram stream.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.generation import speculative as jspec
from paddle_tpu.jit import _LayerBinder
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops import paged_cache as jpc
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.convert import load_jax_params, pool_from_jax
from paddle_tpu_torch.generation import _filter_logits, _paged_prefill
from paddle_tpu_torch.generation import speculative as spec
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import paged_cache as tpc
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.ops.kernels import paged_attention as pda

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# the reference's tiny Llama of its tree tests (tests/test_spec_tree.py)
TINY = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)
TREES = [(0,), (0, 1, 2), (0, 0, 1), (0, 0, 1, 3), (0, 0, 1, 2, 3, 4, 5)]
BRANCHY = (0, 0, 1, 2, 3, 4, 5)       # spine 1-3-5-7, branch 2-4-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def tiny_pair():
    paddle.seed(7)
    ref = JaxLlama(JaxLlamaConfig.tiny(**TINY))
    ref.eval()
    port = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port


# ------------------------------------------------------------ the helpers


@pytest.mark.parametrize("tree", TREES)
def test_tree_helpers_match_reference(tree):
    assert pda.tree_ancestor_bits(tree) == jspec.tree_ancestor_bits(tree)
    assert spec.tree_chain_layout(tree) == jspec.tree_chain_layout(tree)
    _, _, n_leaves, depth = spec.tree_chain_layout(tree)
    chains = [[10 * c + d for d in range(depth)] for c in range(n_leaves)]
    assert spec.tree_fill_from_chains(tree, chains) == \
        jspec.tree_fill_from_chains(tree, chains)


def test_ngram_propose_topk_matches_reference():
    rng = np.random.RandomState(0)
    cases = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 1, 4, 1, 7],
             [1, 2, 1, 2, 1], [4], [1, 2, 3]]
    cases += [list(map(int, rng.randint(0, 5, 30))) for _ in range(20)]
    for h in cases:
        for g, n, m in ((1, 1, 3), (3, 2, 3), (4, 3, 2), (2, 4, 1)):
            got = spec.ngram_propose_topk(h, g, n, m)
            assert got == jspec.ngram_propose_topk(h, g, n, m), (h, g, n)
            assert got[0] == spec.ngram_propose(h, g, m)


@pytest.mark.parametrize("bad", [(1,), (0, 3), (0, 2), tuple(range(32))])
def test_invalid_trees_raise_as_the_reference(bad):
    with pytest.raises(ValueError):
        jspec.tree_ancestor_bits(bad)
    with pytest.raises(ValueError):
        pda.tree_ancestor_bits(bad)
    with pytest.raises(ValueError):
        spec.tree_chain_layout(bad)


# ------------------------------------------------------ the plain K2v mode


def _case(rng, S, T, rep, BS, MB=6, Hkv=2, D=32):
    NB = 1 + S * MB
    tables = np.zeros((S, MB), np.int32)
    lens = rng.randint(1, BS * (MB - 1) - T, S).astype(np.int32)
    lens[0] = BS * (MB - 1) - T + 1        # the window ends at a block's end
    alloc = tpc.BlockAllocator(NB)
    for s in range(S):
        n = tpc.blocks_for(int(lens[s]) + T - 1, BS)
        tables[s, :n] = alloc.alloc(n)
    return (rng.randn(S, T, Hkv * rep, D).astype(np.float32),
            rng.randn(NB, BS, Hkv, D).astype(np.float32),
            rng.randn(NB, BS, Hkv, D).astype(np.float32), tables, lens)


@pytest.mark.parametrize("pool", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("block_size", [8, 16])
@pytest.mark.parametrize("tree", [(0, 0, 1, 3), BRANCHY])
def test_plain_tree_verify_matches_reference(pool, rep, block_size, tree):
    rng = np.random.RandomState(len(tree) + 10 * rep + block_size)
    q, kp, vp, tables, lens = _case(rng, 3, len(tree) + 1, rep, block_size)
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    if pool == "int8":
        jk, jv = (jpc.QuantKV(*jpc.kv_quantize(jnp.asarray(x)))
                  for x in (kp, vp))
        tk, tv = (pool_from_jax(x, "cpu") for x in (jk, jv))
        jq, tq = jnp.asarray(q), _t(q)
    elif pool == "bfloat16":
        jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16)
                      for x in (q, kp, vp))
        tq, tk, tv = (_t(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16) for x in (jq, jk, jv))
    else:
        jq, jk, jv = (jnp.asarray(x) for x in (q, kp, vp))
        tq, tk, tv = _t(q), _t(kp), _t(vp)
    want_k = jpa.pallas_paged_verify_attention(jq, jk, jv, jt, jl,
                                               interpret=True,
                                               tree_anc=tree)
    want_x = jpa._xla_paged_verify(jq, jk, jv, jt, jl, tree_anc=tree)
    n0 = dict(launch_counts)
    got = pda.paged_verify_attention(tq, tk, tv, _t(tables), _t(lens),
                                     tree_anc=tree)
    assert launch_counts == n0          # CPU tensors: the plain version
    tol = BF16_TOL if pool == "bfloat16" else TOL
    for want in (want_k, want_x):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   **tol)
    # the tree is a mask, not the linear bound: the branch rows differ
    lin = pda.plain_paged_verify_attention(tq, tk, tv, _t(tables), _t(lens))
    assert not torch.equal(lin, got)


@pytest.mark.parametrize("pool", ["float32", "int8", "bfloat16"])
def test_chain_tree_equals_linear_bitwise(pool):
    rng = np.random.RandomState(3)
    q, kp, vp, tables, lens = _case(rng, 3, 4, 2, 8)
    if pool == "int8":
        tk, tv = (tpc.QuantKV(*tpc.kv_quantize(_t(x))) for x in (kp, vp))
        tq = _t(q)
    else:
        dt = getattr(torch, pool)
        tq, tk, tv = (_t(x).to(dt) for x in (q, kp, vp))
    args = (tq, tk, tv, _t(tables), _t(lens))
    lin = pda.paged_verify_attention(*args, tree_anc=None)
    assert torch.equal(pda.paged_verify_attention(*args, tree_anc=(0, 1, 2)),
                       lin)


def test_ambient_scope_arms_the_verify_window():
    """Inside ``spec_tree_scope`` the wrapper and the attention step mask
    a window of len(tree) + 1 rows by the tree; a window of another width
    keeps the linear bound, and leaving the scope disarms it."""
    rng = np.random.RandomState(4)
    q, kp, vp, tables, lens = _case(rng, 2, 5, 2, 8)
    args = (_t(q), _t(kp), _t(vp), _t(tables), _t(lens))
    tree = (0, 0, 1, 3)
    want = pda.paged_verify_attention(*args, tree_anc=tree)
    lin = pda.paged_verify_attention(*args, tree_anc=None)
    with pda.spec_tree_scope(tree):
        assert torch.equal(pda.paged_verify_attention(*args), want)
        short = (_t(q[:, :3]),) + args[1:]
        assert torch.equal(pda.paged_verify_attention(*short),
                           pda.paged_verify_attention(*short,
                                                      tree_anc=None))
        kh = _t(rng.randn(2, 5, 2, 32).astype(np.float32))
        kp2, vp2 = _t(kp), _t(vp)
        out, _, _ = tpa.paged_attention_step(_t(q), kh, kh, kp2, vp2,
                                             _t(tables), _t(lens - 1))
    assert torch.equal(pda.paged_verify_attention(*args), lin)
    step_want = pda.plain_paged_verify_attention(
        _t(q), kp2, vp2, _t(tables), _t(lens), tree_anc=tree)
    assert torch.equal(out, step_want)


# ------------------------------------------------------------- acceptance


def _greedy_case(seed, tree, S=6, V=16):
    """Filtered logits whose argmax at each node is a seeded token, and
    windows built so that some slots accept a non-spine branch and some
    carry two siblings with the same token."""
    rng = np.random.RandomState(seed)
    t = len(tree) + 1
    f = rng.randn(S, t, V).astype(np.float32)
    gt = f.argmax(-1)
    toks = rng.randint(0, V, (S, t)).astype(np.int64)
    par = (-1,) + tuple(tree)
    for s in range(S):
        # slot s follows the argmax down its chosen child at each node
        for i in range(1, t):
            if rng.rand() < 0.7:
                toks[s, i] = gt[s, par[i]]
    toks[0, 1] = (gt[0, 0] + 1) % V           # the spine's head rejected
    toks[0, 2] = gt[0, 0]                     # its sibling accepted
    toks[1, 1] = toks[1, 2] = gt[1, 0]        # equal siblings: node 1 wins
    return f, toks


@pytest.mark.parametrize("tree", [(0, 0, 1, 3), BRANCHY, (0, 0, 0, 1, 2)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_tree_acceptance_matches_reference(tree, seed):
    f, toks = _greedy_case(seed, tree)
    want = jspec.accept_tree_from_filtered(
        jnp.asarray(f), jnp.asarray(toks.astype(np.int32)), tree,
        jax.random.PRNGKey(0), do_sample=False)
    got = spec.accept_tree_from_filtered(_t(f), _t(toks), tree, None,
                                         do_sample=False)
    for name, g, w in zip(("out", "accept", "logp", "path", "n_acc"), got,
                          want):
        if name == "logp":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert int(got[3][0, 1]) == 2             # the branch, not the spine
    assert int(got[3][1, 1]) == 1             # equal siblings: lowest id


@pytest.mark.parametrize("dup", [False, True])
def test_tree_rejection_sampling_emits_the_filtered_target(dup):
    """Over 20k seeded rows at V = 6, the first emitted token of a tree
    whose root has two children (and a grandchild) is distributed as the
    filtered target p at the root, also when both children carry one
    token; the statistic's 99.9th percentile at <= 5 degrees of freedom
    is 20.5, and filtered-out tokens never appear."""
    V, S, tree = 6, 20000, (0, 0, 1)
    rng = np.random.RandomState(1)
    raw = torch.from_numpy(rng.randn(len(tree) + 1, V).astype(np.float32)
                           * 1.5)
    f = _filter_logits(raw, do_sample=True, temperature=0.8, top_k=5,
                       top_p=1.0).expand(S, len(tree) + 1, V)
    p0 = torch.softmax(f[0, 0], -1).numpy().astype(np.float64)
    toks = torch.tensor([[0, 3, 3 if dup else 5, 1]]).expand(S, 4)
    g = torch.Generator().manual_seed(42)
    out, accept, _, path, n_acc = spec.accept_tree_from_filtered(
        f, toks, tree, g, do_sample=True)
    counts = np.bincount(out[:, 0].numpy(), minlength=V).astype(np.float64)
    exp = p0 * S
    keep = exp > 5
    chi2 = float(((counts[keep] - exp[keep]) ** 2 / exp[keep]).sum())
    assert chi2 < 20.5, (counts, p0)
    assert (counts[p0 == 0] == 0).all()
    assert 0 < int(accept[:, 0].sum()) < S
    # the accepted path follows the parents; n_acc counts its depth
    assert bool((accept.sum(1) == n_acc).all())
    assert bool(((path[:, 1] == 0) == (n_acc == 0)).all())
    if dup:
        assert not bool((path[:, 1] == 2).any())   # the duplicate: no mass


# ------------------------------------------------------------ compaction


@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_permute_window_matches_reference(pool):
    """Overlapping moves (node 2 -> 1, 4 -> 2, 6 -> 3), an identity path,
    a slot that keeps nothing, and a window crossing a block boundary."""
    rng = np.random.RandomState(9)
    S, BS, MB, Hkv, D = 4, 4, 5, 2, 8
    NB = 1 + S * MB
    tables = (1 + np.random.RandomState(1).permutation(S * MB)) \
        .reshape(S, MB).astype(np.int32)
    lens = np.asarray([3, 9, 0, 6], np.int32)
    perm = np.asarray([[0, 2, 4, 6, 6, 6, 6, 6], [0, 1, 2, 3, 4, 5, 6, 7],
                       [0, 1, 1, 1, 1, 1, 1, 1], [0, 1, 3, 5, 7, 7, 7, 7]],
                      np.int32)
    n_keep = np.asarray([4, 8, 0, 5], np.int32)
    raw = [rng.randn(NB, BS, Hkv, D).astype(np.float32) for _ in "kv"]
    if pool == "int8":
        jp = [jpc.QuantKV(*jpc.kv_quantize(jnp.asarray(x))) for x in raw]
        tp = [pool_from_jax(x, "cpu") for x in jp]
    else:
        jp = [jnp.asarray(x) for x in raw]
        tp = [_t(x) for x in raw]
    want = jpc.permute_window(*jp, jnp.asarray(tables), jnp.asarray(lens),
                              jnp.asarray(perm), jnp.asarray(n_keep))
    got = tpc.permute_window(*tp, _t(tables), _t(lens), _t(perm),
                             _t(n_keep))
    assert got[0] is tp[0] and got[1] is tp[1]     # in place
    for g, w in zip(got, want):
        parts = ((g.data, w.data), (g.scale, w.scale)) if pool == "int8" \
            else ((g, w),)
        for a, b in parts:        # the null block takes the discarded rows
            np.testing.assert_array_equal(a.numpy()[1:], np.asarray(b)[1:])


# --------------------------------------------------- the verify step, e2e


def _ref_prefill(ref, ids, mb, bs):
    binder = _LayerBinder(ref)
    params, buffers = binder.param_arrays(), binder.buffer_arrays()
    step = ref._build_model_step(binder, buffers)
    b, p = ids.shape
    tables = (1 + np.arange(b * mb, dtype=np.int32)).reshape(b, mb)
    dense = ref.init_caches(b, p)
    _, dense = step(params, jnp.asarray(ids), dense,
                    jnp.zeros((), jnp.int32))
    pools = [jpc.write_prefill(kp, vp, jnp.asarray(tables), dk, dv)
             for (kp, vp), (dk, dv) in zip(
                 ref.init_paged_caches(1 + b * mb, bs), dense)]
    return step, params, pools, tables


def _window(port, ids, toks, tree, mb, bs):
    """Fresh prefilled pools and one target forward over the window
    ``toks`` inside ``spec_tree_scope(tree)``: (logits, tables, pools)."""
    _, tables, pools = _paged_prefill(port, _t(ids), mb, bs)
    with pda.spec_tree_scope(tree):
        logits, pools = port(_t(toks), caches=pools, block_tables=tables,
                             cache_lens=torch.tensor([ids.shape[1]],
                                                     dtype=torch.int32))
    return logits, tables, pools


@pytest.mark.parametrize("tree,path", [(BRANCHY, (0, 2, 4, 6)),
                                       ((0, 1, 2), (0, 1, 2, 3))])
@torch.no_grad()
def test_tree_verify_step_matches_reference(tiny_pair, tree, path):
    """One tree verify whose window is built, a depth at a time, so that
    ``path`` is its greedy root path: off the spine in BRANCHY (node 1
    carries a wrong token), the whole chain in (0, 1, 2). Tokens, log
    probabilities and pools equal the reference's; the pools after it are
    the window's rows moved by the path, bit for bit. The model ropes node
    ``j`` at ``lens + j`` as the reference's does, not at its depth, so
    only a chain's pools are a sequential decode's in every layer; off the
    spine, layer 0's V (no position, no context) still is."""
    ref, port = tiny_pair
    bs, mb, P = 8, 4, 13
    ids = np.random.RandomState(5).randint(1, 128, (1, P)).astype(np.int64)
    t = len(tree) + 1
    toks = np.asarray([[0] + [7 + 2 * k for k in range(t - 1)]], np.int64)
    logits, _, _ = _paged_prefill(port, _t(ids), mb, bs)
    toks[0, 0] = int(logits[0, -1].argmax())
    if path[1] != 1:
        toks[0, 1] = (int(logits[0, -1].argmax()) + 1) % 128
    for d in range(1, len(path)):   # node path[d] takes its parent's argmax
        logits, _, _ = _window(port, ids, toks, tree, mb, bs)
        toks[0, path[d]] = int(logits[0, path[d - 1]].argmax())
    logits, tables, window_pools = _window(port, ids, toks, tree, mb, bs)
    bonus = int(logits[0, path[-1]].argmax())

    _, tables, pools = _paged_prefill(port, _t(ids), mb, bs)
    verify = spec.build_tree_verify_step(spec._paged_step(port),
                                         parents=tree, do_sample=False)
    lens = torch.tensor([P], dtype=torch.int32)
    out, accept, logp, pools = verify(pools, tables, lens, _t(toks))
    n_acc = len(path) - 1
    assert out[0, :n_acc + 1].tolist() == \
        [int(toks[0, i]) for i in path[1:]] + [bonus]
    assert accept[0].tolist() == [True] * n_acc + [False] * (t - 1 - n_acc)

    step, params, jpools, jtables = _ref_prefill(ref, ids, mb, bs)
    jverify = jspec.build_tree_verify_step(step, parents=tree,
                                           do_sample=False)
    jout, jacc, jlogp, jpools = jverify(params, jpools, jnp.asarray(jtables),
                                        jnp.asarray([P], jnp.int32),
                                        jnp.asarray(toks.astype(np.int32)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(accept.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), atol=1e-4,
                               rtol=0)
    for (kp, vp), (jk, jv) in zip(pools, jpools):
        np.testing.assert_allclose(kp.numpy()[1:], np.asarray(jk)[1:], **TOL)
        np.testing.assert_allclose(vp.numpy()[1:], np.asarray(jv)[1:], **TOL)

    # the window's rows, moved: position P + j holds node path[j]'s row
    src = torch.tensor([P + i for i in path])
    for got, win in zip(pools, window_pools):
        for a, b in zip(got, win):
            a, b = tpc.gather_dense(a, tables)[0], tpc.gather_dense(
                b, tables)[0]
            assert torch.equal(a[:P], b[:P])
            assert torch.equal(a[P:P + n_acc + 1], b[src])

    # sequential paged decoding of the emitted tokens
    _, tables, seq = _paged_prefill(port, _t(ids), mb, bs)
    for j, i in enumerate(path):
        _, seq = port(torch.tensor([[int(toks[0, i])]]), caches=seq,
                      block_tables=tables,
                      cache_lens=torch.tensor([P + j], dtype=torch.int32))
    keep = P + n_acc + 1
    chain = tuple(path[1:]) == tuple(range(1, len(path)))
    halves = [(li, h) for li in range(len(seq)) for h in (0, 1)] if chain \
        else [(0, 1)]                   # off the spine: layer 0's V
    for li, h in halves:
        np.testing.assert_allclose(
            tpc.gather_dense(pools[li][h], tables)[:, :keep].numpy(),
            tpc.gather_dense(seq[li][h], tables)[:, :keep].numpy(), **TOL)


def _motif_ids(seed, n=16, b=2):
    rng = np.random.RandomState(seed)
    motif = rng.randint(0, 128, (b, 5))
    return np.tile(motif, (1, -(-n // 5)))[:, :n].astype(np.int64)


GENERATE = {"branching_f32": dict(num_speculative_tokens=7,
                                  spec_tree=BRANCHY),
            "chain_int8": dict(num_speculative_tokens=3, spec_tree=(0, 1, 2),
                               kv_cache_dtype="int8")}


@pytest.mark.parametrize("case", list(GENERATE))
def test_generate_spec_tree_matches_reference(tiny_pair, case):
    ref, port = tiny_pair
    ids = _motif_ids(11)
    kw = dict(GENERATE[case], max_new_tokens=8)
    want, want_sc = ref.generate(paddle.to_tensor(ids), **kw)
    got, got_sc = port.generate(torch.from_numpy(ids), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc.numpy()),
                               atol=1e-4, rtol=0)


def test_chain_tree_is_the_linear_ngram_stream(tiny_pair):
    port = tiny_pair[1]
    ids = torch.from_numpy(_motif_ids(12))
    lin = port.generate(ids, max_new_tokens=10, num_speculative_tokens=4)
    tre = port.generate(ids, max_new_tokens=10, num_speculative_tokens=4,
                        spec_tree=(0, 1, 2, 3))
    assert torch.equal(lin[0], tre[0])
    torch.testing.assert_close(lin[1], tre[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(spec_tree=(0, 1)), "num_speculative_tokens > 0"),
    (dict(spec_tree=(0, 1), num_speculative_tokens=3), "must equal"),
    (dict(spec_tree=(0, 2), num_speculative_tokens=2), "earlier node"),
    (dict(spec_tree=(0, 1), num_speculative_tokens=2, draft_model=True),
     "draft_model")])
def test_invalid_spec_tree_options_raise(tiny_pair, kw, match):
    port = tiny_pair[1]
    if kw.get("draft_model"):
        kw = dict(kw, draft_model=port)
    with pytest.raises(ValueError, match=match):
        port.generate(np.ones((1, 4), np.int64), max_new_tokens=2, **kw)


def test_tree_sampling_repeats_with_its_seed(tiny_pair):
    """Sampled tree speculation draws from the generator ``seed`` makes:
    the same seed gives the same tokens and scores, and every token is in
    the vocabulary."""
    port = tiny_pair[1]
    ids = torch.from_numpy(_motif_ids(13))
    kw = dict(max_new_tokens=8, num_speculative_tokens=7, spec_tree=BRANCHY,
              decode_strategy="sampling", top_k=20, seed=11)
    a, b = port.generate(ids, **kw), port.generate(ids, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[0].min()) >= 0 and int(a[0].max()) < 128
