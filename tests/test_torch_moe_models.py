"""The PyTorch port's Qwen2-MoE and DeepSeek-MoE against the JAX package
on the CPU — the slice as a whole.

Both tiny families get the reference's weights through
``load_jax_params`` (names and shapes must round-trip). In float32:
the dense forward's logits within 1e-4 and the loss with the router aux
term within 1e-5 (the same model summed in another order), dropless and
capacity-routed; the port ``ServingEngine``'s greedy tokens equal the
reference engine's; greedy ``generate()`` on the dense cache, the paged
cache and n-gram speculation at gamma 2 gives the reference's tokens,
with scores within 1e-4. A capacity-routed model is refused by the
engine and excluded from prompt bucketing and speculation, the MoE
``stats()`` keys are present for a dense Llama too, and a q/k/v-biased
attention serves on the unfused path while the fused one refuses it.

Training, in float32 (Qwen2-MoE capacity-routed, its default and the
reference bench's; DeepSeek-MoE dropless): the loss (criterion plus
router aux) within 1e-5 and every parameter's gradient, by the
reference's name, within 1e-4 of its largest value against the
reference's ``loss.backward()``, on the fused and the sorted path; three
``TrainStep`` + AdamW steps against the reference's compiled
``TrainStep`` (losses rtol 1e-5; parameters at the Llama training test's
bounds: every element within 5e-5, and all but 1e-4 of the elements
within 2e-6); three eager steps with ``ClipGradForMOEByGlobalNorm``
against the reference's eager loop (the same tolerances). Both
optimizers take ``epsilon=1e-6`` here: Adam's first step moves an
element by ``lr * g / (|g| + eps)``, so a gradient element near ``eps``
turns its last-bit rounding (the two packages sum in other orders) into
a visible part of a step, at a gain of up to ``lr / eps``. These tiny
MoE models have many such elements (experts that few tokens reach, and
Qwen2's k_proj bias, whose gradient is zero in exact arithmetic: it adds
one constant to all of a query's scores), and tensors of 32 to 4096
elements, so the count of elements past 2e-6 is taken over the whole
model rather than per tensor, and leaves out the k_proj biases (held to
the 5e-5 bound only: Adam steps them by their rounding noise, which
neither package shares);
``collect_drop_rates`` equal to the reference's on a capacity-routed
Qwen2-MoE.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JaxServingConfig
from paddle_tpu.distributed.moe import \
    ClipGradForMOEByGlobalNorm as JaxMoeClip
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.deepseek_moe import \
    DeepseekMoeConfig as JaxDeepseekConfig
from paddle_tpu.models.deepseek_moe import \
    DeepseekMoeForCausalLM as JaxDeepseek
from paddle_tpu.models.qwen2_moe import Qwen2MoeConfig as JaxQwenConfig
from paddle_tpu.models.qwen2_moe import Qwen2MoeForCausalLM as JaxQwen
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.distributed import moe
from paddle_tpu_torch.distributed.moe import ClipGradForMOEByGlobalNorm
from paddle_tpu_torch.generation import speculative as spec
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.models import (DeepseekMoeConfig,
                                     DeepseekMoeForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, Qwen2MoeConfig,
                                     Qwen2MoeForCausalLM)
from paddle_tpu_torch.optimizer import AdamW

FAMILIES = {
    "qwen2": (JaxQwenConfig, JaxQwen, Qwen2MoeConfig, Qwen2MoeForCausalLM,
              dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2,
                   moe_ffn=32, shared_ffn=48, experts=4, topk=2)),
    "deepseek": (JaxDeepseekConfig, JaxDeepseek, DeepseekMoeConfig,
                 DeepseekMoeForCausalLM,
                 dict(vocab=128, hidden=64, layers=3, heads=4, kv_heads=4,
                      moe_ffn=32, dense_ffn=48, experts=8, shared=2,
                      topk=2)),
}
CORE = dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8)
NEW = 8


def _build(family, dropless, seed=7):
    jcfg_cls, jcls, tcfg_cls, tcls, shape = FAMILIES[family]
    paddle.seed(seed)
    jcfg = jcfg_cls.tiny(**shape)
    jcfg.dropless = dropless
    ref = jcls(jcfg)
    ref.eval()
    tcfg = tcfg_cls.tiny(**shape)
    tcfg.dropless = dropless
    port = tcls(tcfg, device="cpu")
    named = {k: np.asarray(v) for k, v in ref.state_dict().items()}
    load_jax_params(port, named)
    return ref, port, named


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    """(family, reference, port, named weights): dropless."""
    return (request.param,) + _build(request.param, True)


def _ids(b=2, n=11, seed=0):
    return np.random.RandomState(seed).randint(1, 128, (b, n)).astype(
        np.int64)


def test_names_and_shapes_round_trip(pair):
    _, _, port, named = pair
    own = dict(port.named_parameters())
    assert set(own) == set(named)
    for name, p in own.items():
        assert tuple(p.shape) == named[name].shape, name
        np.testing.assert_array_equal(p.detach().numpy(), named[name])
    assert any(n.endswith("experts.gate_up_proj") for n in own)


@pytest.mark.parametrize("dropless", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dense_logits_and_loss_match_reference(family, dropless):
    ref, port, _ = _build(family, dropless, seed=11)
    ids = _ids(b=3, n=16, seed=1)
    labels = np.roll(ids, -1, axis=1)
    want = np.asarray(ref(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
        loss = float(port(torch.from_numpy(ids),
                          labels=torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    loss_ref = float(ref(paddle.to_tensor(ids),
                         labels=paddle.to_tensor(labels)).numpy())
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)


def _prompts():
    rng = np.random.RandomState(0)
    # ragged lengths; 21 > prefill_chunk spans three chunk ticks; four
    # prompts over two slots exercise admission after a retirement
    return [rng.randint(1, 128, size=n).tolist() for n in (5, 21, 3, 12)]


def test_engine_greedy_streams_match_reference(pair):
    _, ref, port, _ = pair
    prompts = _prompts()
    jeng = JaxServingEngine(ref, JaxServingConfig(
        **CORE, enable_prefix_cache=False, enable_preemption=False,
        health=False, async_depth=0))
    want = jeng.serve(prompts, max_new_tokens=NEW)
    jeng.shutdown()
    eng = ServingEngine(port, ServingConfig(
        **CORE, enable_prefix_cache=False, enable_preemption=False),
        device="cpu")
    got = eng.serve(prompts, max_new_tokens=NEW)
    st = eng.stats()
    assert eng.shutdown()
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")
    n_sparse = sum(hasattr(lay.mlp, "experts")
                   for lay in port.base.layers)
    assert st["moe"] is True and st["moe_fused_gmm"] is True
    assert st["moe_dispatches"] == n_sparse * st["ticks"]
    assert 0.0 < st["moe_routing_entropy"] <= 1.0
    assert 0.0 < st["moe_expert_load_max"] <= 1.0


@pytest.mark.parametrize("mode", ["dense", "paged", "ngram"])
def test_generate_matches_reference(pair, mode):
    _, ref, port, _ = pair
    kw = {"dense": dict(cache_impl="dense"),
          "paged": dict(cache_impl="paged"),
          "ngram": dict(num_speculative_tokens=2)}[mode]
    # a motif repeated, so the n-gram drafter finds continuations
    motif = np.random.RandomState(3).randint(1, 128, (2, 6))
    ids = np.tile(motif, (1, 2))[:, :11].astype(np.int64)
    out_ref, sc_ref = ref.generate(paddle.to_tensor(ids),
                                   max_new_tokens=NEW, **kw)
    out, sc = port.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                            **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_ref.numpy()))
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_ref.numpy()),
                               atol=1e-4, rtol=1e-4)


def test_sorted_path_gives_the_fused_paths_logits(pair):
    family, _, port, named = pair
    cfg = FAMILIES[family][2].tiny(**FAMILIES[family][4])
    cfg.dropless, cfg.moe_fused_gmm = True, False
    sorted_model = FAMILIES[family][3](cfg, device="cpu")
    load_jax_params(sorted_model, named)
    ids = torch.from_numpy(_ids())
    with torch.no_grad():
        np.testing.assert_allclose(sorted_model(ids).numpy(),
                                   port(ids).numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_capacity_routed_moe_is_refused_and_excluded(family):
    _, port, _ = _build(family, False, seed=3)
    with pytest.raises(NotImplementedError, match="dropless=True"):
        ServingEngine(port, ServingConfig(**CORE), device="cpu")
    assert port._bucket_eligible() is False
    assert "capacity-routed MoE" in spec.spec_exclusion_reason(port)
    with pytest.raises(NotImplementedError, match="capacity-routed"):
        port.generate(torch.from_numpy(_ids()), max_new_tokens=2,
                      num_speculative_tokens=2)
    port.config.dropless = True
    assert port._bucket_eligible() is True
    assert spec.spec_exclusion_reason(port) is None


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_capacity_routed_reads_both_expert_namings(family):
    """One helper decides capacity routing for the engine, prompt
    bucketing and speculation: Qwen2's ``num_experts`` and DeepSeek's
    ``n_routed_experts`` alike, a dense config never."""
    cfg = FAMILIES[family][2].tiny(**FAMILIES[family][4])
    assert moe.num_routed_experts(cfg) == FAMILIES[family][4]["experts"]
    assert moe.capacity_routed(cfg) is True
    cfg.dropless = True
    assert moe.capacity_routed(cfg) is False
    dense = LlamaConfig.tiny()
    assert moe.num_routed_experts(dense) == 0
    assert moe.capacity_routed(dense) is False


def test_moe_stats_keys_present_for_a_dense_llama():
    m = LlamaForCausalLM(LlamaConfig.tiny(vocab=64, hidden=64, layers=1,
                                          heads=4, kv_heads=2, ffn=64),
                         device="cpu")
    eng = ServingEngine(m, ServingConfig(**CORE), device="cpu")
    eng.serve([[1, 2, 3]], max_new_tokens=2)
    st = eng.stats()
    assert (st["moe"], st["moe_fused_gmm"], st["moe_dispatches"],
            st["moe_routing_entropy"], st["moe_expert_load_max"]) == \
        (False, False, 0, 0.0, 0.0)


def test_biased_attention_refuses_the_fused_decode_path():
    """q/k/v biases (Qwen2) no longer send the engine off the fused
    decode path: K3a carries them in its epilogue, and the fused tick
    serves the unfused path's tokens."""
    cfg = LlamaConfig.tiny(vocab=64, hidden=64, layers=1, heads=4,
                           kv_heads=2, ffn=64)
    cfg.qkv_bias = True
    m = LlamaForCausalLM(cfg, device="cpu")
    assert m.llama.layers[0].self_attn.q_proj.bias.shape == (64,)
    with torch.no_grad():
        m.llama.layers[0].self_attn.q_proj.bias.normal_(
            0.0, 0.5, generator=torch.Generator().manual_seed(2))
    streams = {}
    for fused in (False, True):
        eng = ServingEngine(m, ServingConfig(**CORE, fused_decode=fused),
                            device="cpu")
        streams[fused] = eng.serve([[1, 2, 3]], max_new_tokens=2)
        eng.shutdown()
    assert len(streams[True][0]) == 2
    np.testing.assert_array_equal(streams[True][0], streams[False][0])


# -- training -----------------------------------------------------------

TRAIN_DROPLESS = {"qwen2": False, "deepseek": True}


def _train_batches(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(1, 128, (2, 12)).astype(np.int64)
        out.append((ids, np.roll(ids, -1, axis=1)))
    return out


def _train_pair(family, fused=True):
    ref, port, _ = _build(family, TRAIN_DROPLESS[family], seed=13)
    ref.train()
    port.config.moe_fused_gmm = fused
    return ref, port


@functools.lru_cache(maxsize=None)
def _reference_grads(family):
    ref, _ = _train_pair(family)
    ids, labels = _train_batches(1, seed=5)[0]
    loss = ref(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss.backward()
    return float(loss.numpy()), {n: np.asarray(p.grad.numpy())
                                 for n, p in ref.named_parameters()}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_every_gradient_match_reference(family, fused):
    loss_ref, grads_ref = _reference_grads(family)
    _, port = _train_pair(family, fused)
    ids, labels = _train_batches(1, seed=5)[0]
    moe.reset_moe_stats()
    loss = port(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    assert moe.moe_stats()["grouped_mm_kernel"] == (
        "fused_gmm" if fused else "gmm")
    np.testing.assert_allclose(float(loss.detach()), loss_ref, rtol=1e-5)
    named = dict(port.named_parameters())
    assert set(named) == set(grads_ref)
    for name, want in grads_ref.items():
        got = named[name].grad
        assert got is not None, name
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * scale,
                                   rtol=0, err_msg=name)
    experts = [n for n in named if n.endswith("experts.down_proj")]
    assert experts and all(named[n].grad.abs().sum() > 0 for n in experts)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_recompute_loss_and_every_gradient_match_reference(family):
    """``config.recompute`` (every layer, the router's aux loss carried out
    through the checkpoint): the reference's loss and gradients within
    1e-5 of each tensor's largest value, the port's own plain run's bit
    for bit, and the host counters (``MOE_STATS``) of one forward."""
    loss_ref, grads_ref = _reference_grads(family)
    _, port = _train_pair(family)
    ids, labels = (torch.from_numpy(a) for a in _train_batches(1, seed=5)[0])
    runs = []
    for on in (True, False):
        port.config.recompute = on
        port.zero_grad(set_to_none=True)
        moe.reset_moe_stats()
        loss = port(ids, labels=labels)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad.clone()
                                     for n, p in port.named_parameters()},
                     moe.moe_stats()))
    (loss, grads, stats), (loss0, grads0, stats0) = runs
    np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5)
    for name, want in grads_ref.items():
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(grads[name].numpy(), want,
                                   atol=1e-5 * scale, rtol=0, err_msg=name)
        assert torch.equal(grads[name], grads0[name]), name
    assert torch.equal(loss, loss0) and stats == stats0


ADAM = dict(weight_decay=0.01, epsilon=1e-6)


def _assert_params_close(port, ref):
    want = {n: np.asarray(p.numpy()) for n, p in ref.named_parameters()}
    over = size = 0
    for name, p in port.named_parameters():
        d = np.abs(p.detach().numpy() - want[name])
        assert d.max() <= 5e-5, (name, float(d.max()))
        if not name.endswith("k_proj.bias"):    # a zero gradient
            over += int((d > 2e-6).sum())
            size += d.size
    assert over <= 1e-4 * size, (over, size)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_trajectory_matches_reference(family):
    ref, port = _train_pair(family)
    opt_r = JaxAdamW(1e-3, parameters=ref.parameters(), **ADAM)
    opt_p = AdamW(1e-3, parameters=port.parameters(), **ADAM)
    step_r = JaxTrainStep(ref, lambda out, a, k: out, opt_r)
    step_p = TrainStep(port, lambda out, a, k: out, opt_p)
    losses_r, losses_p = [], []
    for ids, labels in _train_batches(3, seed=6):
        losses_r.append(float(step_r(paddle.to_tensor(ids),
                                     paddle.to_tensor(labels)).numpy()))
        losses_p.append(float(step_p(ids, labels)))
    np.testing.assert_allclose(losses_p, losses_r, rtol=1e-5)
    _assert_params_close(port, ref)


def test_eager_loop_with_moe_clip_matches_reference():
    ref, port = _train_pair("deepseek")
    clip_p = ClipGradForMOEByGlobalNorm(0.5, is_expert_param_func=lambda p:
                                        p.dim() == 3)
    assert isinstance(clip_p, ClipGradByGlobalNorm)
    opt_r = JaxAdamW(1e-3, parameters=ref.parameters(),
                     grad_clip=JaxMoeClip(0.5), **ADAM)
    opt_p = AdamW(1e-3, parameters=port.parameters(), grad_clip=clip_p,
                  **ADAM)
    for ids, labels in _train_batches(3, seed=7):
        loss_r = ref(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        loss_r.backward()
        opt_r.step()
        opt_r.clear_grad()
        loss_p = port(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss_p.backward()
        opt_p.step()
        opt_p.clear_grad()
        np.testing.assert_allclose(float(loss_p.detach()),
                                   float(loss_r.numpy()), rtol=1e-5)
    _assert_params_close(port, ref)


def test_collect_drop_rates_match_reference():
    ref, port, _ = _build("qwen2", False, seed=17)
    # a longer batch, so capacity 1.25 of 4 experts drops pairs
    ids = np.random.RandomState(9).randint(1, 128, (4, 24)).astype(np.int64)
    port.train()
    want = ref.collect_drop_rates(paddle.to_tensor(ids))
    got = port.collect_drop_rates(ids)
    assert port.training and len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=1e-7)
    assert max(got) > 0
