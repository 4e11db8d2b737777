"""Beam and group-beam search and the exported generation artifact of the
PyTorch port against the JAX package on the CPU.

A tiny float32 Llama (2 layers, hidden 64, vocabulary 48) and a tiny
float32 GPT get the reference's weights through ``load_jax_params``.
``generate(decode_strategy="beam_search" | "group_beam_search")`` must
give the reference's tokens exactly and its scores within 1e-5: without
an EOS (every hypothesis runs to full length), with an EOS the first
step already proposes (finished hypotheses under the length penalty, the
ties of the ``NEG`` entries) under both exit rules, and with the
diversity penalty between groups. One beam is greedy search. The
reference's refusals raise as the reference's do. The artifact that
``export_generation`` writes (json + npz, no pickle) is loaded back and
gives the reference's loaded artifact's tokens, greedy and beam.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.generation import GenerationConfig as JaxGenerationConfig
from paddle_tpu.generation import load_generation as jax_load_generation
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.generation import GenerationConfig, load_generation
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)

LLAMA = dict(vocab=48, hidden=64, layers=2, heads=4, kv_heads=2, ffn=96)
GPT = dict(vocab=48, hidden=64, layers=2, heads=2)
B, PROMPT, NEW = 2, 8, 6


def _load(ref, port):
    ref.eval()
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port.eval()


@pytest.fixture(scope="module")
def llama():
    paddle.seed(5)
    return _load(JaxLlama(JaxLlamaConfig.tiny(**LLAMA)),
                 LlamaForCausalLM(LlamaConfig.tiny(**LLAMA), device="cpu"))


@pytest.fixture(scope="module")
def gpt():
    paddle.seed(9)
    return _load(JaxGPT(JaxGPTConfig.tiny(**GPT)),
                 GPTForCausalLM(GPTConfig.tiny(**GPT), device="cpu"))


def _ids(seed=0):
    return np.random.RandomState(seed).randint(
        0, 48, (B, PROMPT)).astype(np.int64)


def _both(pair, ids, **kw):
    ref, port = pair
    out_r, sc_r = ref.generate(paddle.to_tensor(ids), max_new_tokens=NEW,
                               **kw)
    out_p, sc_p = port.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                                **kw)
    assert out_p.dtype == torch.int64 and sc_p.dtype == torch.float32
    assert tuple(out_p.shape) == (B, NEW) and tuple(sc_p.shape) == (B,)
    return (np.asarray(out_r.numpy()), np.asarray(sc_r.numpy()),
            out_p.numpy(), sc_p.numpy())


def _first_greedy(port, ids):
    """The token greedy search picks first for row 0: as EOS, the first
    step already proposes it."""
    out, _ = port.generate(torch.from_numpy(ids), max_new_tokens=1)
    return int(out[0, 0])


CASES = {
    "beam_no_eos": dict(decode_strategy="beam_search", num_beams=4,
                        length_penalty=1.0),
    "beam_eos_bound": dict(decode_strategy="beam_search", num_beams=3,
                           length_penalty=0.6, eos="first"),
    "beam_eos_early": dict(decode_strategy="beam_search", num_beams=2,
                           early_stopping=True, length_penalty=-0.5,
                           eos="first"),
    "group_diverse": dict(decode_strategy="group_beam_search", num_beams=4,
                          num_beam_groups=2, diversity_rate=0.5,
                          eos="first"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_matches_reference_llama(llama, case):
    kw = dict(CASES[case])
    ids = _ids()
    if kw.pop("eos", None):
        kw["eos_token_id"] = _first_greedy(llama[1], ids)
    out_r, sc_r, out_p, sc_p = _both(llama, ids, **kw)
    np.testing.assert_array_equal(out_p, out_r)
    np.testing.assert_allclose(sc_p, sc_r, rtol=1e-5, atol=1e-5)
    if "eos_token_id" in kw:
        # the EOS ends a hypothesis: pads follow it in the picked row
        for row in out_p:
            hit = np.nonzero(row == kw["eos_token_id"])[0]
            if hit.size:
                assert (row[hit[0] + 1:] == kw["eos_token_id"]).all()


def test_group_beam_matches_reference_gpt(gpt):
    out_r, sc_r, out_p, sc_p = _both(
        gpt, _ids(1), decode_strategy="group_beam_search", num_beams=4,
        num_beam_groups=2, diversity_rate=1.0, length_penalty=1.0)
    np.testing.assert_array_equal(out_p, out_r)
    np.testing.assert_allclose(sc_p, sc_r, rtol=1e-5, atol=1e-5)


def test_one_beam_is_greedy_search(llama):
    ids = torch.from_numpy(_ids(2))
    greedy, g_score = llama[1].generate(ids, max_new_tokens=NEW)
    beam, b_score = llama[1].generate(ids, max_new_tokens=NEW,
                                      decode_strategy="beam_search",
                                      num_beams=1)
    assert torch.equal(beam, greedy)
    torch.testing.assert_close(b_score, g_score, rtol=1e-6, atol=1e-6)


REFUSALS = {
    "left_padded": (dict(decode_strategy="beam_search", num_beams=2,
                         attention_mask=np.ones((B, PROMPT), np.int64)),
                    NotImplementedError),
    "sampling_knobs": (dict(decode_strategy="beam_search", num_beams=2,
                            temperature=0.7), ValueError),
    "groups_without_group_beam": (dict(decode_strategy="beam_search",
                                       num_beams=4, num_beam_groups=2),
                                  ValueError),
    "diversity_without_group_beam": (dict(decode_strategy="beam_search",
                                          num_beams=2, diversity_rate=0.5),
                                     ValueError),
    "beams_without_beam_strategy": (dict(num_beams=2), ValueError),
    "paged_cache": (dict(decode_strategy="beam_search", num_beams=2,
                         cache_impl="paged"), NotImplementedError),
    "speculation": (dict(decode_strategy="beam_search", num_beams=2,
                         num_speculative_tokens=2), NotImplementedError),
    "negative_penalty": (dict(decode_strategy="beam_search", num_beams=2,
                              length_penalty=-1.0), ValueError),
    "groups_not_dividing": (dict(decode_strategy="group_beam_search",
                                 num_beams=3, num_beam_groups=2),
                            ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_beam_refusals_match_reference(llama, case):
    kw, exc = REFUSALS[case]
    ids = _ids()
    for i, model in enumerate(llama):
        call = dict(kw)
        if "attention_mask" in call and i == 0:
            call["attention_mask"] = paddle.to_tensor(call["attention_mask"])
        with pytest.raises(exc):
            model.generate(paddle.to_tensor(ids) if i == 0
                           else torch.from_numpy(ids), max_new_tokens=NEW,
                           **call)


@pytest.mark.parametrize("strategy", ["greedy_search", "beam_search"])
def test_load_generation_matches_reference_artifact(llama, tmp_path,
                                                    strategy):
    kw = dict(decode_strategy=strategy, max_new_tokens=NEW)
    if strategy == "beam_search":
        kw.update(num_beams=3, length_penalty=1.0)
    ref, port = llama
    ids = _ids(3)
    ref.export_generation(str(tmp_path / "ref"), B, PROMPT, NEW,
                          JaxGenerationConfig(**kw))
    want = jax_load_generation(str(tmp_path / "ref"))(ids)
    path = port.export_generation(str(tmp_path / "port"), B, PROMPT, NEW,
                                  GenerationConfig(**kw))
    meta = json.loads((tmp_path / "port.json").read_text())
    assert {"batch", "prompt_len", "max_new_tokens", "n_params",
            "seed_dtype"} <= set(meta)
    assert (meta["batch"], meta["prompt_len"], meta["max_new_tokens"]) == \
        (B, PROMPT, NEW)
    assert meta["generation_config"]["decode_strategy"] == strategy
    # weights only: the archive loads without pickle
    np.load(str(tmp_path / "port.params.npz"), allow_pickle=False)
    gen = load_generation(path, device="cpu")
    got = gen(ids)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    same, _ = port.generate(torch.from_numpy(ids), pad_prompt_to_bucket=False,
                            **kw)
    np.testing.assert_array_equal(got, same.numpy())
    with pytest.raises(ValueError, match="exported"):
        gen(ids[:, :PROMPT - 1])


def test_load_generation_round_trips_bf16_and_sampling(tmp_path):
    m = LlamaForCausalLM(LlamaConfig.tiny(**LLAMA), device="cpu", seed=3)
    m = m.to(torch.bfloat16)
    m.config.dtype = "bfloat16"
    cfg = GenerationConfig(decode_strategy="sampling", top_k=5,
                           max_new_tokens=NEW)
    m.export_generation(str(tmp_path / "a"), B, PROMPT, NEW, cfg)
    gen = load_generation(str(tmp_path / "a"), device="cpu")
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              gen.model.state_dict().items()):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), k
    ids = _ids(4)
    want, _ = m.generate(torch.from_numpy(ids), generation_config=cfg,
                         seed=11, pad_prompt_to_bucket=False)
    np.testing.assert_array_equal(gen(ids, seed=11), want.numpy())
