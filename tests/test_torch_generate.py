"""The PyTorch port's ``generate()`` against the JAX package on the CPU —
the slice as a whole.

A tiny float32 Llama (2 layers, hidden 256, 8 / 4 heads) and a smaller
draft model get the reference's weights through ``load_jax_params``.
Greedy ``generate()`` must give the reference's tokens exactly and its
scores within 1e-4 (the same model summed in another order) on the dense
cache, the paged cache, n-gram speculation at gamma 2 and 4, a draft
model, a prompt that bucketing left-pads and a caller's left-padded
mask; the port's dense, paged and speculative greedy streams must agree
with each other, as the reference pins for its own. The option guards
raise as the reference's do; the options of later slices run since they
were ported (int8 pools, tree speculation, beam and group-beam search
against the reference's tokens, the exported artifact round-tripping to
``generate()``'s tokens). Sampling cannot be compared across packages
(the RNG streams differ): the port's rejection sampling is held to the
filtered target distribution by a chi-square test instead.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.generation import GenerationConfig, load_generation
from paddle_tpu_torch.generation import _filter_logits
from paddle_tpu_torch.generation import speculative as spec
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

TARGET = dict(vocab=128, hidden=256, layers=2, heads=8, kv_heads=4, ffn=256)
DRAFT = dict(vocab=128, hidden=128, layers=1, heads=4, kv_heads=2, ffn=128)
NEW = 10


def _pair(seed, shape):
    paddle.seed(seed)
    ref = JaxLlama(JaxLlamaConfig.tiny(**shape))
    ref.eval()
    port = LlamaForCausalLM(LlamaConfig.tiny(**shape), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def target():
    return _pair(7, TARGET)


@pytest.fixture(scope="module")
def draft():
    return _pair(13, DRAFT)


def _prompt(n, seed=0, b=2):
    """``b`` prompts of ``n`` tokens, each an 8-token motif repeated, so
    the n-gram drafter finds continuations."""
    rng = np.random.RandomState(seed)
    motif = rng.randint(0, 128, (b, 8))
    return np.tile(motif, (1, -(-n // 8)))[:, :n].astype(np.int64)


def _ref(model, ids, **kw):
    if "draft_model" in kw:
        kw["draft_model"] = kw["draft_model"][0]
    if "attention_mask" in kw:
        kw["attention_mask"] = paddle.to_tensor(kw["attention_mask"])
    out, sc = model.generate(paddle.to_tensor(ids), **kw)
    return np.asarray(out.numpy()), np.asarray(sc.numpy())


def _port(model, ids, **kw):
    if "draft_model" in kw:
        kw["draft_model"] = kw["draft_model"][1]
    out, sc = model.generate(torch.from_numpy(ids), **kw)
    assert out.dtype == torch.int64 and sc.dtype == torch.float32
    return out.numpy(), sc.numpy()


CASES = {
    "dense": (16, dict()),
    "paged": (16, dict(cache_impl="paged")),
    "ngram_gamma2": (16, dict(num_speculative_tokens=2)),
    "ngram_gamma4": (16, dict(num_speculative_tokens=4)),
    "draft_model": (16, dict(num_speculative_tokens=2, draft_model=True)),
    "bucket_pads_prompt": (11, dict()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_matches_reference(target, draft, case):
    n, kw = CASES[case]
    if kw.get("draft_model"):
        kw = dict(kw, draft_model=draft)
    ids = _prompt(n)
    want, want_sc = _ref(target[0], ids, max_new_tokens=NEW, **kw)
    got, got_sc = _port(target[1], ids, max_new_tokens=NEW, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_sc, want_sc, atol=1e-4, rtol=0)


def test_left_padded_mask_matches_reference(target):
    ids = _prompt(12, seed=3)
    mask = np.ones_like(ids)
    mask[0, :4] = 0
    want, want_sc = _ref(target[0], ids, max_new_tokens=6,
                         attention_mask=mask)
    got, got_sc = _port(target[1], ids, max_new_tokens=6,
                        attention_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_sc, want_sc, atol=1e-4, rtol=0)


def test_dense_paged_and_speculative_agree(target):
    """The port's own paths give one greedy stream (its scores within
    1e-4): the paged pool is a re-layout of the dense cache, and the
    verify window emits the target's own argmax chain. A model drafting
    for itself accepts every draft, so windows commit gamma + 1 tokens
    and the last one overhangs into the table's headroom."""
    model = target[1]
    ids = _prompt(13, seed=5)
    runs = [_port(model, ids, max_new_tokens=NEW, **kw) for kw in (
        dict(pad_prompt_to_bucket=False), dict(cache_impl="paged"),
        dict(num_speculative_tokens=3),
        dict(num_speculative_tokens=3, draft_model=(None, model)))]
    for got, sc in runs[1:]:
        np.testing.assert_array_equal(got, runs[0][0])
        np.testing.assert_allclose(sc, runs[0][1], atol=1e-4, rtol=0)
    gen = spec.SpecGenerator(model, 2, 13, NEW, 3, do_sample=False,
                             temperature=1.0, top_k=0, top_p=1.0, eos=-1,
                             pad=0, block_size=16, draft_model=model)
    out, _ = gen.run(torch.from_numpy(ids))
    np.testing.assert_array_equal(out, runs[0][0])
    assert gen.verify_steps == -(-(NEW - 1) // 4)


def test_return_hidden_matches_reference(target):
    """``forward(..., return_hidden=True)`` on the cache path gives
    ``((logits, final hidden state), caches)``: both the reference's, and
    the logits those of the call without it."""
    import jax.numpy as jnp
    from paddle_tpu.jit import _LayerBinder
    ref, port = target
    ids = _prompt(9, seed=2)
    binder = _LayerBinder(ref)
    step = ref._build_model_step(binder, binder.buffer_arrays(),
                                 want_hidden=True)
    (lg_r, h_r), _ = step(binder.param_arrays(),
                          jnp.asarray(ids.astype(np.int32)),
                          ref.init_caches(*ids.shape),
                          jnp.zeros((), jnp.int32))
    with torch.no_grad():
        (lg, h), _ = port(torch.from_numpy(ids),
                          caches=port.init_caches(*ids.shape), offset=0,
                          return_hidden=True)
        plain, _ = port(torch.from_numpy(ids),
                        caches=port.init_caches(*ids.shape), offset=0)
    assert h.shape == (*ids.shape, TARGET["hidden"])
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(lg.numpy(), plain.numpy())


def test_eos_inside_speculative_window(target):
    """EOS found mid-window truncates exactly like the sequential loop:
    the EOS is emitted, everything after it is pad."""
    ids = np.random.RandomState(4).randint(0, 128, (1, 6)).astype(np.int64)
    base, _ = _port(target[1], ids, max_new_tokens=NEW)
    eos = int(base[0, 3])
    want, _ = _ref(target[0], ids, max_new_tokens=NEW, eos_token_id=eos)
    seq, _ = _port(target[1], ids, max_new_tokens=NEW, eos_token_id=eos)
    got, _ = _port(target[1], ids, max_new_tokens=NEW, eos_token_id=eos,
                   num_speculative_tokens=4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(seq, want)
    first = int(np.argmax(got[0] == eos))
    assert first <= 3 and (got[0, first + 1:] == eos).all()


GUARDS = [
    (dict(decode_strategy="bogus"), NotImplementedError, "decode_strategy"),
    (dict(cache_impl="bogus"), ValueError, "cache_impl"),
    (dict(foo=1), TypeError, "unsupported options"),
    (dict(num_beams=2), ValueError, "num_beams"),
    (dict(num_speculative_tokens=-1), ValueError, "num_speculative_tokens"),
    (dict(draft_model=True), ValueError, "draft_model"),
    (dict(cache_impl="dense", num_speculative_tokens=2), ValueError,
     "paged"),
    (dict(cache_impl="paged", attention_mask=True), NotImplementedError,
     "left-padded"),
    (dict(num_speculative_tokens=2, attention_mask=True),
     NotImplementedError, "left-padded"),
    (dict(attention_mask="right"), ValueError, "LEFT"),
    (dict(max_new_tokens=2048), ValueError, "max_position_embeddings"),
]


@pytest.mark.parametrize("kw,exc,match", GUARDS,
                         ids=[m for _, _, m in GUARDS])
def test_option_guards_raise_as_the_reference(target, draft, kw, exc,
                                              match):
    ids = np.ones((1, 4), np.int64)
    kw = dict(kw)
    mask = {True: np.ones((1, 4), np.int64),
            "right": np.asarray([[1, 1, 1, 0]])}
    for i, model in enumerate(target):
        call = dict(max_new_tokens=2)
        call.update(kw)
        if "attention_mask" in call:
            m = mask[call["attention_mask"]]
            call["attention_mask"] = paddle.to_tensor(m) if i == 0 \
                else torch.from_numpy(m)
        if call.get("draft_model"):
            call["draft_model"] = draft[i]
        run = model.generate
        with pytest.raises(exc, match=match):
            run(paddle.to_tensor(ids) if i == 0 else torch.from_numpy(ids),
                **call)


def test_draft_vocab_mismatch_raises(target):
    other = LlamaForCausalLM(LlamaConfig.tiny(vocab=64, hidden=64, layers=1,
                                              heads=2, kv_heads=1, ffn=64),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="vocab"):
        target[1].generate(np.ones((1, 4), np.int64), max_new_tokens=2,
                           num_speculative_tokens=2, draft_model=other)


@pytest.mark.parametrize("kw", [
    dict(decode_strategy="beam_search", num_beams=2),
    dict(decode_strategy="group_beam_search", num_beams=2),
    dict(spec_tree=(0, 0), num_speculative_tokens=2),
    dict(kv_cache_dtype="int8")], ids=["beam", "group_beam", "spec_tree",
                                       "int8_kv"])
def test_later_slice_options_raise(target, kw):
    if "spec_tree" in kw:
        # tree speculation is ported: the option runs on the paged cache
        out, sc = target[1].generate(np.ones((1, 4), np.int64),
                                     max_new_tokens=2, **kw)
        assert tuple(out.shape) == (1, 2) and tuple(sc.shape) == (1,)
        return
    if "kv_cache_dtype" in kw:
        # int8 pools are ported: the option runs on the paged cache, and
        # only an explicit dense cache with it is refused
        out, _ = target[1].generate(np.ones((1, 4), np.int64),
                                    max_new_tokens=2, **kw)
        assert tuple(out.shape) == (1, 2)
        with pytest.raises(ValueError, match="paged cache"):
            target[1].generate(np.ones((1, 4), np.int64), max_new_tokens=2,
                               cache_impl="dense", **kw)
        return
    # beam and group-beam search are ported: the reference's tokens and
    # scores on the dense cache, and only the paged cache is refused
    ids = _prompt(8)
    want, want_sc = _ref(target[0], ids, max_new_tokens=4, **kw)
    got, got_sc = _port(target[1], ids, max_new_tokens=4, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_sc, want_sc, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="paged"):
        target[1].generate(np.ones((1, 4), np.int64), max_new_tokens=2,
                           cache_impl="paged", **kw)


def test_export_and_load_generation_raise(target, tmp_path):
    # export / load are ported: the artifact round-trips to generate()'s
    # tokens; a missing artifact and a prompt of another shape raise
    ids = _prompt(8)
    path = target[1].export_generation(str(tmp_path / "g"), 2, 8, 4)
    gen = load_generation(path, device="cpu")
    want, _ = target[1].generate(torch.from_numpy(ids), max_new_tokens=4,
                                 pad_prompt_to_bucket=False)
    np.testing.assert_array_equal(gen(ids), want.numpy())
    with pytest.raises(ValueError, match="exported"):
        gen(ids[:1])
    with pytest.raises(FileNotFoundError):
        load_generation(str(tmp_path / "missing"))


def test_generation_config_and_bucket():
    assert GenerationConfig().max_new_tokens == 20
    from paddle_tpu.generation import _prompt_bucket as ref_bucket
    from paddle_tpu_torch.generation import _prompt_bucket
    for n in (1, 8, 9, 16, 17, 100, 600):
        assert _prompt_bucket(n) == ref_bucket(n)


def test_ngram_propose_matches_reference():
    from paddle_tpu.generation.speculative import ngram_propose as ref
    rng = np.random.RandomState(0)
    cases = [[5, 6, 7, 8, 9, 5, 6, 7], [1, 2, 9, 1, 2], [1, 2, 3], [4]]
    cases += [list(rng.randint(0, 5, 30)) for _ in range(20)]
    for h in cases:
        for g in (1, 3, 4):
            assert spec.ngram_propose(h, g) == ref(h, g), (h, g)


# ------------------------------------------------------------- sampling


def _chi2(counts, probs):
    exp = probs * counts.sum()
    keep = exp > 5
    return float(((counts[keep] - exp[keep]) ** 2 / exp[keep]).sum())


@pytest.mark.parametrize("onehot", [True, False])
@pytest.mark.parametrize("filtered", [False, True])
def test_rejection_sampling_emits_the_filtered_target(onehot, filtered):
    """Over 20k seeded rows at V = 6, gamma 2, the first emitted token
    is distributed as the filtered target p at the window's first
    position, for the one-hot drafter (a fixed proposal) and for an
    explicit draft distribution dq (a deliberately poor one). The
    statistic's 99.9th percentile at <= 5 degrees of freedom is 20.5;
    filtered-out tokens never appear."""
    V, G, S = 6, 2, 20000
    rng = np.random.RandomState(0)
    knobs = dict(do_sample=True, temperature=0.8 if filtered else 1.0,
                 top_k=4 if filtered else 0, top_p=1.0)
    raw = torch.from_numpy(rng.randn(G + 1, V).astype(np.float32) * 1.5)
    f = _filter_logits(raw, **knobs).expand(S, G + 1, V)
    p0 = torch.softmax(f[0, 0], -1).numpy().astype(np.float64)
    g = torch.Generator().manual_seed(42)
    if onehot:
        toks = torch.tensor([[0, 3, 5]]).expand(S, G + 1)
        dq = None
    else:
        q_row = torch.from_numpy(
            rng.dirichlet(np.full(V, 0.3), size=G).astype(np.float32))
        draft = torch.multinomial(q_row, S, replacement=True,
                                  generator=g).T            # [S, G]
        toks = torch.cat([torch.zeros(S, 1, dtype=torch.int64), draft], 1)
        dq = q_row.expand(S, G, V)
    out, accept, _ = spec.accept_from_filtered(f, toks, dq, g, gamma=G,
                                               do_sample=True)
    counts = np.bincount(out[:, 0].numpy(), minlength=V).astype(np.float64)
    assert _chi2(counts, p0) < 20.5, (counts, p0)
    assert (counts[p0 == 0] == 0).all()
    assert 0 < int(accept[:, 0].sum()) < S


def test_sampling_repeats_with_its_seed(target, draft):
    ids = _prompt(16)
    for kw in (dict(), dict(cache_impl="paged"),
               dict(num_speculative_tokens=3),
               dict(num_speculative_tokens=2, draft_model=(None,
                                                           draft[1]))):
        a = _port(target[1], ids, max_new_tokens=8, seed=11,
                  decode_strategy="sampling", top_k=20, **kw)
        b = _port(target[1], ids, max_new_tokens=8, seed=11,
                  decode_strategy="sampling", top_k=20, **kw)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
