"""The PyTorch port's dense Qwen2 against the JAX package's on the CPU —
the slice as a whole.

A tiny float32 Qwen2 (2 layers, hidden 256, 4 / 2 heads, q/k/v biases
drawn away from the reference's zero init so that they count) crosses to
the port through ``params_from_jax``. The full forward must give the
reference's logits within 1e-5 (the same float32 model summed in another
order), greedy ``generate()`` the reference's tokens, and the port's
``ServingEngine`` on the fused decode path (K3a with the q/k/v biases)
the reference engine's greedy streams.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JaxServingConfig
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.models.qwen2 import Qwen2Config as JaxQwen2Config
from paddle_tpu.models.qwen2 import Qwen2ForCausalLM as JaxQwen2
from paddle_tpu_torch.convert import load_jax_params, params_from_jax
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import (Qwen2Config, Qwen2ForCausalLM,
                                     Qwen2Model, Qwen2PretrainingCriterion)

TINY = dict(vocab=128, hidden=256, layers=2, heads=4, kv_heads=2, ffn=256)
CORE = dict(num_slots=2, block_size=8, max_model_len=64, prefill_chunk=8)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(5)
    ref = JaxQwen2(JaxQwen2Config.tiny(**TINY))
    ref.eval()
    rng = np.random.RandomState(5)
    for name, p in ref.named_parameters():
        if name.endswith("bias"):
            p.set_value((0.5 * rng.randn(*p.shape)).astype(np.float32))
    named = {k: np.asarray(v) for k, v in ref.state_dict().items()}
    port = Qwen2ForCausalLM(Qwen2Config.tiny(**TINY), device="cpu")
    load_jax_params(port, named)
    return ref, port, named


def _prompts():
    rng = np.random.RandomState(1)
    return [rng.randint(1, 128, size=n).tolist() for n in (5, 13, 3)]


def test_config_and_parameters_follow_the_reference(pair):
    ref, port, named = pair
    cfg = Qwen2Config()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.max_position_embeddings,
            cfg.rope_theta, cfg.qkv_bias) == (151936, 3584, 18944, 28, 28,
                                              4, 32768, 1e6, True)
    assert isinstance(port.base, Qwen2Model)
    assert Qwen2PretrainingCriterion is type(port.criterion)
    sd = params_from_jax(named, device="cpu")
    own = dict(port.named_parameters())
    assert set(sd) == set(own) == set(named)
    biases = [k for k in named if k.endswith("bias")]
    assert len(biases) == 3 * TINY["layers"]
    for k in biases:   # the biases cross as they are, nonzero
        np.testing.assert_array_equal(own[k].detach().numpy(), named[k])
        assert np.abs(named[k]).max() > 0


def test_forward_logits_match_reference(pair):
    ref, port, _ = pair
    ids = np.random.RandomState(2).randint(0, 128, (2, 24)).astype(np.int64)
    want = np.asarray(ref(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_greedy_generate_matches_reference(pair):
    ref, port, _ = pair
    ids = np.random.RandomState(3).randint(0, 128, (2, 9)).astype(np.int64)
    want, _ = ref.generate(paddle.to_tensor(ids), max_new_tokens=6)
    got, _ = port.generate(torch.from_numpy(ids), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_fused_engine_streams_match_reference(pair):
    ref, port, _ = pair
    prompts = _prompts()
    eng = JaxServingEngine(ref, JaxServingConfig(
        **CORE, enable_prefix_cache=False, enable_preemption=False,
        health=False, async_depth=0))
    want = eng.serve(prompts, max_new_tokens=6)
    eng.shutdown()
    eng = ServingEngine(port, ServingConfig(
        **CORE, fused_decode=True, enable_prefix_cache=False,
        enable_preemption=False), device="cpu")
    got = eng.serve(prompts, max_new_tokens=6)
    eng.shutdown()
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
