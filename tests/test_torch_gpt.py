"""The PyTorch port's GPT against the JAX package on the CPU — the slice as
a whole, and its new pieces one by one.

A tiny float32 GPT at head_dim 64 (vocab 96, hidden 128, 2 heads, 2
layers, dropout 0 wherever outputs cross packages) gets the reference's
weights through ``load_jax_params``; the reference's biases and LayerNorm
parameters are drawn away from its zero / one init, and its embeddings
scaled to 0.1 of its N(0, 1) init, so that every parameter counts and
greedy streams do not just repeat a token. Tolerances (float32):

- ``layer_norm``, ``gelu`` (both modes), ``LayerNorm`` and the degree-1
  tensor-parallel layers: 1e-6 (the same ops in another library);
- the dense logits: rtol 1e-5, atol 1e-5; the loss rtol 1e-6; every
  gradient of one eager backward atol 1e-5 (the same sums in another
  order, through 2 layers); 3 ``TrainStep`` + AdamW steps: losses rtol
  1e-5, each parameter tensor within 2e-6 but for at most 1e-4 of its
  elements (and 3), all within 1e-4, a tenth of a step (the Llama
  training test's rule: Adam's ``lr * g / (|g| + eps)`` turns the last
  bits of a gradient near zero into a visible part of a step), and the
  k third of the q/k/v bias, whose gradient is zero but for rounding,
  within its 3 Adam steps;
- ``generate()`` (dense, paged, n-gram, draft model, token tree) and the
  engine (fused and unfused, float32 and int8 pools, speculating):
  token-exact; fused ON == OFF inside the port: token-exact;
- the K2 kernels' new mode, a bfloat16 query over float32 pools (GPT's
  pools stay float32 under a bfloat16 model): the plain versions against
  the reference's interpreted TPU kernel on the same inputs, within one
  bfloat16 ulp (each rounds one float32 output; both keep P in float32).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import mp_layers as jmp
from paddle_tpu.inference import ServingConfig as JaxServingConfig
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import \
    GPTPretrainingCriterion as JaxGPTCriterion
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.convert import load_jax_params, params_from_jax
from paddle_tpu_torch.distributed.fleet import (ColumnParallelLinear,
                                                RowParallelLinear,
                                                VocabParallelEmbedding)
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, GPTModel,
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.nn import Dropout, LayerNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import paged_cache as tpc
from paddle_tpu_torch.ops.kernels import decode_fused as df
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.ops.kernels import paged_attention as pda
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab=96, hidden=128, layers=2, heads=2)
DRAFT = dict(vocab=96, hidden=128, layers=1, heads=2)
CORE = dict(num_slots=2, block_size=8, max_model_len=64, prefill_chunk=8)
F32 = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(port, ref):
    """A reference layer's weights into a port layer, under the same
    names (a layer has no ``device`` for ``load_jax_params``)."""
    port.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in ref.state_dict().items()}, "cpu"))


def _cfg(shape, dropout=0.0):
    cfg = JaxGPTConfig.tiny(**shape)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    return cfg


def _port_cfg(shape, dropout=0.0):
    cfg = GPTConfig.tiny(**shape)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    return cfg


def _pair(seed, shape=TINY):
    """A reference GPT with every parameter drawn to count, and the port
    model carrying its weights."""
    paddle.seed(seed)
    ref = JaxGPT(_cfg(shape))
    rng = np.random.RandomState(seed)
    for name, p in ref.named_parameters():
        a = np.asarray(p.numpy())
        if name.endswith("bias"):
            a = 0.1 * rng.randn(*a.shape)
        elif ".ln_" in name:
            a = 1.0 + 0.1 * rng.randn(*a.shape)
        elif "embeddings" in name:
            a = 0.1 * a
        p.set_value(a.astype(np.float32))
    port = GPTForCausalLM(_port_cfg(shape), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def models():
    ref, port = _pair(3)
    ref_d, port_d = _pair(11, DRAFT)
    for m in (ref, port, ref_d, port_d):
        m.eval()
    return ref, port, ref_d, port_d


def _prompts(n=(5, 13, 3), seed=1):
    """Lengths around a repeated motif, so the n-gram drafter finds
    continuations; 13 tokens at chunk 8 span two chunk ticks."""
    rng = np.random.RandomState(seed)
    motif = rng.randint(1, 96, 4).tolist()
    return [motif * 2 + rng.randint(1, 96, k).tolist() for k in n]


# ------------------------------------------------------ the new layers


@pytest.mark.parametrize("shape", [(4, 7, 128), (3, 2, 5, 16)])
def test_layer_norm_and_gelu_match_reference(shape):
    rng = np.random.RandomState(len(shape))
    x = (3.0 * rng.randn(*shape) + 0.5).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    px = paddle.to_tensor(x)
    want = np.asarray(JF.layer_norm(px, shape[-1], paddle.to_tensor(w),
                                    paddle.to_tensor(b), 1e-5).numpy())
    got = F.layer_norm(_t(x), shape[-1], _t(w), _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    # over the two trailing axes, no affine
    want2 = np.asarray(JF.layer_norm(px, list(shape[-2:])).numpy())
    np.testing.assert_allclose(
        F.layer_norm(_t(x), list(shape[-2:])).numpy(), want2, **F32)
    for approximate in (False, True):
        np.testing.assert_allclose(
            F.gelu(_t(x), approximate=approximate).numpy(),
            np.asarray(JF.gelu(px, approximate=approximate).numpy()),
            **F32)


def test_layer_norm_is_k3a_plain_ln_bitwise():
    """The module path's LayerNorm -> projection and K3a's plain
    ``kind="ln"`` are one recipe (fused ON == OFF rests on it), in
    float32 and bfloat16."""
    rng = np.random.RandomState(4)
    for dt in (torch.float32, torch.bfloat16):
        x, g, b = (_t(rng.randn(*s).astype(np.float32)).to(dt)
                   for s in ((6, 64), (64,), (64,)))
        w, bias = (_t(rng.randn(*s).astype(np.float32)).to(dt)
                   for s in ((64, 24), (24,)))
        (fused,) = df.plain_norm_matmul(x, g, b, [w], [bias], eps=1e-5,
                                        kind="ln")
        assert torch.equal(fused, F.layer_norm(x, 64, g, b, 1e-5) @ w + bias)
        y, r = (_t(rng.randn(6, 24).astype(np.float32)).to(dt)
                for _ in "yr")
        w2 = _t(rng.randn(24, 24).astype(np.float32)).to(dt)
        assert torch.equal(
            df.plain_matmul_residual([y], w2, bias, r, act="gelu_tanh"),
            r + (F.gelu(y, approximate=True) @ w2 + bias))


def test_layer_norm_module_matches_reference():
    rng = np.random.RandomState(5)
    ref = paddle.nn.LayerNorm(32, 1e-5)
    ref.weight.set_value(rng.randn(32).astype(np.float32))
    ref.bias.set_value(rng.randn(32).astype(np.float32))
    port = LayerNorm(32, 1e-5, device="cpu")
    assert [n for n, _ in port.named_parameters()] == ["weight", "bias"]
    assert torch.equal(port.weight, torch.ones(32)) \
        and torch.equal(port.bias, torch.zeros(32))
    _load(port, ref)
    x = rng.randn(3, 32).astype(np.float32)
    np.testing.assert_allclose(
        port(_t(x)).detach().numpy(),
        np.asarray(ref(paddle.to_tensor(x)).numpy()), **F32)
    assert port._epsilon == 1e-5


def test_mp_layers_at_degree_one_match_reference():
    paddle.seed(2)
    rng = np.random.RandomState(2)
    pairs = [(jmp.ColumnParallelLinear(16, 24, gather_output=False),
              ColumnParallelLinear(16, 24, gather_output=False,
                                   device="cpu"), (5, 16)),
             (jmp.RowParallelLinear(24, 16, input_is_parallel=True),
              RowParallelLinear(24, 16, input_is_parallel=True,
                                device="cpu"), (5, 24)),
             (jmp.ColumnParallelLinear(16, 8, has_bias=False),
              ColumnParallelLinear(16, 8, has_bias=False, device="cpu"),
              (5, 16)),
             (jmp.RowParallelLinear(8, 16, has_bias=False),
              RowParallelLinear(8, 16, has_bias=False, device="cpu"),
              (5, 8))]
    for ref, port, xs in pairs:
        for name, p in ref.named_parameters():
            p.set_value(rng.randn(*p.shape).astype(np.float32))
        named = {k: np.asarray(v) for k, v in ref.state_dict().items()}
        assert sorted(named) == sorted(n for n, _ in port.named_parameters())
        assert tuple(port.weight.shape) == tuple(named["weight"].shape)
        _load(port, ref)
        x = rng.randn(*xs).astype(np.float32)
        np.testing.assert_allclose(
            port(_t(x)).detach().numpy(),
            np.asarray(ref(paddle.to_tensor(x)).numpy()), rtol=1e-6,
            atol=1e-5)
    ref = jmp.VocabParallelEmbedding(40, 8)
    port = VocabParallelEmbedding(40, 8, device="cpu")
    _load(port, ref)
    ids = rng.randint(0, 40, (3, 5))
    np.testing.assert_array_equal(
        port(_t(ids)).detach().numpy(),
        np.asarray(ref(paddle.to_tensor(ids)).numpy()))
    # the reference's bias defaults: column and row both biased, zero
    assert torch.equal(ColumnParallelLinear(4, 6, device="cpu").bias,
                       torch.zeros(6))
    assert RowParallelLinear(4, 6, device="cpu").bias is not None
    for layer, args in ((ColumnParallelLinear, (4, 6)),
                        (RowParallelLinear, (4, 6)),
                        (VocabParallelEmbedding, (10, 4))):
        for group in (2, object()):
            with pytest.raises(NotImplementedError, match="item 11"):
                layer(*args, mp_group=group, device="cpu")


def test_dropout_module_is_seeded_and_inert_in_eval():
    x = torch.ones(64, 32)
    a = Dropout(0.25, generator=torch.Generator().manual_seed(5))
    b = Dropout(0.25, generator=torch.Generator().manual_seed(5))
    ya, yb = a(x), b(x)
    assert torch.equal(ya, yb)                     # same seed, same mask
    assert not torch.equal(ya, a(x))               # the stream moves on
    kept = ya != 0
    assert 0.6 < float(kept.float().mean()) < 0.9
    assert torch.allclose(ya[kept], torch.full_like(ya[kept], 1 / 0.75))
    a.eval()
    assert a(x) is x                               # eval: the identity
    assert Dropout(0.0)(x) is x


# ------------------------------------------------------ model and training


def test_config_and_parameters_follow_the_reference(models):
    ref, port, _, _ = models
    cfg = GPTConfig()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.intermediate_size,
            cfg.max_position_embeddings, cfg.hidden_dropout_prob,
            cfg.attention_probs_dropout_prob, cfg.layer_norm_epsilon,
            cfg.head_dim) == (50304, 1024, 24, 16, 4096, 1024, 0.1, 0.1,
                              1e-5, 64)
    assert GPTConfig.tiny() == GPTConfig(
        vocab_size=1024, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=512,
        max_position_embeddings=512)
    named = {k: np.asarray(v) for k, v in ref.state_dict().items()}
    own = dict(port.named_parameters())
    assert set(own) == set(named) == set(params_from_jax(named, "cpu"))
    assert len(own) == 2 + 12 * TINY["layers"] + 2
    assert isinstance(port.gpt, GPTModel)
    for k, v in named.items():          # biases and positions cross as-is
        np.testing.assert_array_equal(own[k].detach().numpy(), v)
    # the port's own init: PaddleNLP's (normal(0, 0.02), LN one, biases 0)
    fresh = GPTForCausalLM(GPTConfig.tiny(**TINY), device="cpu", seed=1)
    p = dict(fresh.named_parameters())
    assert torch.equal(p["gpt.h.0.ln_1.weight"], torch.ones(128))
    assert not p["gpt.h.1.linear2.bias"].any()
    assert 0.015 < float(p["gpt.embeddings.weight"].detach().std()) < 0.025
    # the caches are float32 under a bfloat16 model, as the reference's
    fresh = fresh.to(torch.bfloat16)
    assert fresh.init_caches(1, 4)[0][0].dtype == torch.float32
    assert fresh.init_paged_caches(3, 8)[0][0].dtype == torch.float32
    assert isinstance(fresh.init_paged_caches(3, 8, "int8")[0][0],
                      tpc.QuantKV)


def _batches(n, seed, b=2, l=16):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TINY["vocab"], (b, l)).astype(np.int64)
            for _ in range(n)]


def test_forward_loss_and_every_gradient_match_reference():
    ref, port = _pair(7)
    ref.train()
    port.train()
    ids = _batches(1, 0)[0]
    labels = np.roll(ids, -1, axis=1)
    with torch.no_grad():
        logits = port(_t(ids))
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(ref(paddle.to_tensor(ids)).numpy()),
                               rtol=1e-5, atol=1e-5)
    loss_r = ref(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss_r.backward()
    loss_p = port(_t(ids), labels=_t(labels))
    loss_p.backward()
    np.testing.assert_allclose(float(loss_p.detach()),
                               float(loss_r.numpy()), rtol=1e-6)
    grads = {n: np.asarray(p.grad.numpy()) for n, p in ref.named_parameters()}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], atol=1e-5,
                                   rtol=0, err_msg=name)
    assert len(grads) == len(list(port.parameters()))


def test_criterion_matches_reference():
    rng = np.random.RandomState(1)
    logits = (3 * rng.randn(2, 5, 40)).astype(np.float32)
    labels = rng.randint(0, 40, (2, 5))
    want = float(JaxGPTCriterion()(paddle.to_tensor(logits),
                                   paddle.to_tensor(labels)).numpy())
    got = float(GPTPretrainingCriterion()(_t(logits), _t(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_train_step_trajectory_matches_reference():
    ref, port = _pair(8)
    ref.train()
    port.train()
    opt_r = JaxAdamW(1e-3, parameters=ref.parameters(), weight_decay=0.01)
    opt_p = AdamW(1e-3, parameters=port.parameters(), weight_decay=0.01)
    step_r = JaxTrainStep(ref, lambda out, a, k: out, opt_r)
    step_p = TrainStep(port, lambda out, a, k: out, opt_p)
    before = {n: p.detach().numpy().copy()
              for n, p in port.named_parameters()}
    losses_r, losses_p = [], []
    for ids in _batches(1, 1) * 3:      # one batch: the loss falls
        labels = np.roll(ids, -1, axis=1)
        losses_r.append(float(step_r(paddle.to_tensor(ids),
                                     labels=paddle.to_tensor(labels))
                              .numpy()))
        losses_p.append(float(step_p(ids, labels=labels)))
    np.testing.assert_allclose(losses_p, losses_r, rtol=1e-5)
    assert losses_p[-1] < losses_p[0]
    want = {n: np.asarray(p.numpy()) for n, p in ref.named_parameters()}
    h = TINY["hidden"]
    for name, p in port.named_parameters():
        got, ref_p = p.detach().numpy(), want[name]
        if name.endswith("qkv_proj.bias"):
            # the k bias adds q . b_k to every score of a row, which the
            # softmax cancels: its gradient is zero but for rounding, which
            # Adam scales up to a full step of either sign in each package
            # (lr * g / (|g| + eps)); it may only have moved by 3 such
            # steps and its decay
            k0 = before[name][h:2 * h]
            assert np.abs(got[h:2 * h] - k0).max() <= 3.1e-3
            got, ref_p = np.delete(got, np.s_[h:2 * h]), \
                np.delete(ref_p, np.s_[h:2 * h])
        d = np.abs(got - ref_p)
        assert d.max() <= 1e-4, (name, float(d.max()))
        assert (d > 2e-6).sum() <= max(3, 1e-4 * d.size), name


def test_train_step_honors_optimizer_param_subset():
    """``AdamW(parameters=[subset])`` freezes everything outside the
    subset (the reference's ``test_models.py`` case, on the port)."""
    port = GPTForCausalLM(GPTConfig.tiny(vocab=64, hidden=64, layers=2,
                                         heads=1), device="cpu", seed=0)
    port.train()
    names = {"gpt.h.0.attn.qkv_proj.weight", "gpt.h.1.attn.qkv_proj.weight"}
    subset = [p for n, p in port.named_parameters() if n in names]
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    step = TrainStep(port, lambda out, a, k: out, AdamW(1e-2,
                                                        parameters=subset))
    data = np.random.RandomState(0).randint(0, 64, (4, 16))
    for _ in range(2):
        step(data, labels=data)
    for name, p in port.named_parameters():
        assert torch.equal(p, before[name]) != (name in names), name


def test_dropout_is_live_in_training_only():
    port = GPTForCausalLM(_port_cfg(TINY, dropout=0.5), device="cpu")
    ids = _t(_batches(1, 2)[0])
    port.train()
    assert not torch.equal(port(ids), port(ids))
    port.eval()
    with torch.no_grad():
        assert torch.equal(port(ids), port(ids))


# ------------------------------------------------------ generate()


GENERATE = {
    "dense": dict(),
    "paged": dict(cache_impl="paged"),
    "ngram": dict(num_speculative_tokens=3),
    "draft": dict(num_speculative_tokens=2),
    "tree": dict(num_speculative_tokens=4, spec_tree=(0, 0, 1, 3)),
}


@pytest.mark.parametrize("case", list(GENERATE))
def test_greedy_generate_matches_reference(models, case):
    ref, port, ref_d, port_d = models
    ids = np.asarray(_prompts((3, 3))[:2])
    kw = GENERATE[case]
    want, _ = ref.generate(paddle.to_tensor(ids), max_new_tokens=8,
                           **kw, **({"draft_model": ref_d}
                                    if case == "draft" else {}))
    got, scores = port.generate(_t(ids), max_new_tokens=8, **kw,
                                **({"draft_model": port_d}
                                   if case == "draft" else {}))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    assert got.shape == (2, 8) and bool((scores <= 0).all())


def test_sampling_is_seeded_and_padded_prompts_refused(models):
    _, port, _, _ = models
    ids = _t(np.asarray(_prompts((3, 3))[:2]))
    kw = dict(max_new_tokens=8, decode_strategy="sampling", top_k=20,
              top_p=0.95, temperature=0.7, seed=11)
    a, _ = port.generate(ids, **kw)
    b, _ = port.generate(ids, **kw)
    assert torch.equal(a, b) and int(a.max()) < TINY["vocab"]
    # GPT's forward takes no pad mask, as the reference's: refused there
    # too, and prompts are never bucket-padded
    with pytest.raises(NotImplementedError, match="left-padded"):
        port.generate(ids, max_new_tokens=2,
                      attention_mask=np.ones(tuple(ids.shape), np.int64))
    assert not port._bucket_eligible()
    with pytest.raises(ValueError, match="max_position_embeddings"):
        port.generate(ids, max_new_tokens=512)


# ------------------------------------------------------ the engine


def _serve_jax(model, prompts, new, draft=None, **kw):
    eng = JaxServingEngine(model, JaxServingConfig(
        **dict(CORE, **kw), enable_prefix_cache=False,
        enable_preemption=False, health=False, async_depth=0),
        draft_model=draft)
    out = eng.serve(prompts, max_new_tokens=new)
    eng.shutdown()
    return out


def _serve_port(model, prompts, new, draft=None, **kw):
    eng = ServingEngine(model, ServingConfig(
        **dict(CORE, **kw), enable_prefix_cache=False,
        enable_preemption=False), device="cpu", draft_model=draft)
    out = eng.serve(prompts, max_new_tokens=new)
    st = eng.stats()
    assert eng.shutdown()
    return out, st


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")


ENGINES = {
    "fused": dict(fused_decode=True),
    "unfused": dict(fused_decode=False),
    "int8": dict(kv_cache_dtype="int8"),
    "ngram": dict(num_speculative_tokens=3),
    "draft": dict(num_speculative_tokens=3, drafter="model"),
    "tree_int8": dict(num_speculative_tokens=4, spec_tree=(0, 0, 1, 3),
                      kv_cache_dtype="int8"),
    "heads": dict(num_speculative_tokens=4, spec_tree=(0, 0, 1, 1),
                  drafter="heads"),
}


@pytest.mark.parametrize("run", list(ENGINES))
def test_engine_greedy_streams_match_reference(models, run):
    ref, port, ref_d, port_d = models
    kw = ENGINES[run]
    prompts = _prompts()
    jkw = {k: v for k, v in kw.items() if k != "fused_decode"}
    want = _serve_jax(ref, prompts, 8, draft=ref_d if run == "draft"
                      else None, **jkw)
    got, st = _serve_port(port, prompts, 8, draft=port_d if run == "draft"
                          else None, **kw)
    _assert_streams_equal(got, want)
    assert st["kv_cache_dtype"] == kw.get("kv_cache_dtype", "float32")


def test_fused_on_equals_off_and_heads_engine(models):
    """Fused ON == OFF token-exact inside the port (the reference's
    ``test_decode_fused.py`` GPT case), on float32 and int8 pools and
    speculating with draft heads over ``return_hidden``."""
    _, port, _, _ = models
    prompts = _prompts()
    for kw in (dict(), dict(kv_cache_dtype="int8"),
               dict(num_speculative_tokens=4, spec_tree=(0, 0, 1, 1),
                    drafter="heads")):
        on, _ = _serve_port(port, prompts, 8, fused_decode=True, **kw)
        off, _ = _serve_port(port, prompts, 8, fused_decode=False, **kw)
        _assert_streams_equal(on, off)
    # a window past the learned positions is refused up front
    with pytest.raises(ValueError, match="max_position_embeddings"):
        ServingEngine(port, ServingConfig(max_model_len=510,
                                          num_speculative_tokens=3),
                      device="cpu")


# ------------------------------- K2 with a bfloat16 query over float32 pools


def _pools(rng, S, MB, BS, H, D):
    NB = 1 + S * MB
    tables = (1 + np.arange(S * MB, dtype=np.int32)).reshape(S, MB)
    kp, vp = (rng.randn(NB, BS, H, D).astype(np.float32) for _ in "kv")
    return tables, kp, vp


def _bf16_ulps(a, b):
    """bfloat16 ulps between two arrays of bfloat16 bits (int16): the
    sign-magnitude patterns mapped onto one ordered integer line."""
    def line(x):
        x = x.astype(np.int32)
        return np.where(x < 0, -(x & 0x7FFF), x)
    return np.abs(line(a) - line(b))


def _bf16(rng, *shape):
    """bfloat16 values, as jax and torch arrays holding the same bits."""
    j = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(
        jnp.bfloat16)
    return j, _t(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("case", ["decode", "verify", "verify_tree",
                                  "ragged", "ragged_tree"])
def test_bf16_query_over_f32_pools_matches_interpreted_kernel(case):
    rng = np.random.RandomState(len(case))
    S, MB, BS, H, D = 3, 5, 8, 2, 64
    tables, kp, vp = _pools(rng, S, MB, BS, H, D)
    lens = np.asarray([3, 9, 33], np.int32)
    pools = (jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
             jnp.asarray(lens))
    tpools = (_t(kp), _t(vp), _t(tables), _t(lens))
    tree = (0, 0, 1) if case.endswith("tree") else None
    n0 = dict(launch_counts)
    if case == "decode":
        jq, tq = _bf16(rng, S, H, D)
        want = jpa.pallas_paged_attention(jq, *pools, interpret=True)
        got = pda.paged_decode_attention(tq, *tpools)
    elif case.startswith("verify"):
        jq, tq = _bf16(rng, S, 4, H, D)
        want = jpa.pallas_paged_verify_attention(jq, *pools, interpret=True,
                                                 tree_anc=tree)
        got = pda.paged_verify_attention(tq, *tpools, tree_anc=tree)
    else:
        q_lens = np.asarray([1, 4, 4], np.int32)
        starts = np.asarray([0, 1, 5], np.int32)
        flags = np.asarray([0, 1, 1], np.int32)
        jq, tq = _bf16(rng, int(q_lens.sum()), H, D)
        want = jpa.pallas_ragged_paged_attention(
            jq, *pools, jnp.asarray(q_lens), jnp.asarray(starts), w_max=4,
            interpret=True, tree_anc=tree,
            tree_slots=None if tree is None else jnp.asarray(flags))
        got = rpa.ragged_paged_attention(
            tq, *tpools, _t(q_lens), _t(starts), 4, tree_anc=tree,
            tree_slots=None if tree is None else _t(flags))
    assert launch_counts == n0          # CPU tensors: the plain version
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    # both round one float32 output to bfloat16: at most one ulp apart
    ulps = _bf16_ulps(got.view(torch.int16).numpy(),
                      np.asarray(want).view(np.int16))
    assert int(ulps.max()) <= 1, int(ulps.max())


def test_pool_operands_take_exactly_bf16_over_f32():
    """The wrappers' shared dtype check: a bfloat16 query over float32
    pools is the new mode (dtype code 2, counted ``*_f32pool``); every
    other mismatch still raises."""
    bf, f32 = torch.bfloat16, torch.float32
    pool = lambda dt: torch.zeros(3, 8, 2, 64, dtype=dt)  # noqa: E731
    q = lambda dt: torch.zeros(4, 2, 64, dtype=dt)        # noqa: E731
    kd = rpa.pool_operands(q(bf), pool(f32), pool(f32))[0]
    assert rpa.dtype_code(q(bf), kd) == (2, "_f32pool")
    assert rpa.dtype_code(q(bf), pool(bf)) == (1, "")
    assert rpa.dtype_code(q(f32), pool(f32)) == (0, "")
    for qd, kdt, vdt in ((f32, bf, bf), (bf, torch.float16, torch.float16),
                         (bf, f32, bf), (bf, bf, f32), (f32, f32, bf)):
        with pytest.raises(TypeError, match="share q's dtype"):
            rpa.pool_operands(q(qd), pool(kdt), pool(vdt))
    # the bf16 plain versions over float32 pools keep float32 products:
    # not the result of rounding the pools to bfloat16 first
    rng = np.random.RandomState(9)
    tables, kp, vp = _pools(rng, 2, 2, 8, 2, 64)
    _, tq = _bf16(rng, 2, 2, 64)
    lens = _t(np.asarray([5, 16], np.int32))
    got = pda.plain_paged_decode_attention(tq, _t(kp), _t(vp), _t(tables),
                                           lens)
    wide = pda.plain_paged_decode_attention(tq.float(), _t(kp), _t(vp),
                                            _t(tables), lens)
    assert torch.equal(got, wide.to(bf))
