"""``TrainStep``'s telemetry in the PyTorch port against the JAX
package's on the CPU.

The same call sequence (two steps, a step at a new batch shape, one more
at the first shape) on a tiny Llama in each package must leave the same
three counters under each step's ``telemetry_name``:
``train_step_compiles`` 1, ``train_step_calls`` 4 and
``train_step_fallback_recompiles`` 1 (the reference's executable misses
the new signature once and drops to its caching path; the port counts
the same miss). ``step_report(name)`` carries the reference's keys, one
report a step in ``step_reports()``, with counted FLOPs that cover the
forward and the backward, a recomputed model's replayed segments twice
over (each layer up to the last op the backward needs saved), and
``analytic_mfu`` divides them by a step time and the peak.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor as jmon
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab=64, hidden=64, layers=2, heads=4, kv_heads=2, ffn=96)
COUNTERS = ("train_step_compiles", "train_step_calls",
            "train_step_fallback_recompiles")


def _batch(n, seed=0):
    ids = np.random.RandomState(seed).randint(0, 64, (2, n)).astype(
        np.int64)
    return ids, np.roll(ids, -1, axis=1)


def _drive(step, wrap):
    for n in (16, 16, 8, 16):
        ids, labels = _batch(n)
        step(wrap(ids), wrap(labels))


def _counts(mon, name):
    return {c: mon.counter(c, labels=("step",)).labels(step=name).value()
            for c in COUNTERS}


@pytest.fixture(scope="module")
def reference():
    paddle.seed(4)
    ref = JaxLlama(JaxLlamaConfig.tiny(**TINY))
    ref.train()
    weights = {k: np.asarray(v) for k, v in ref.state_dict().items()}
    step = JaxTrainStep(ref, lambda out, a, k: out,
                        JaxAdamW(1e-3, parameters=ref.parameters()))
    _drive(step, lambda a: paddle.to_tensor(a))
    return (weights, _counts(jmon, step.telemetry_name),
            jmon.step_report(step.telemetry_name))


def _port(weights, recompute=False):
    cfg = LlamaConfig.tiny(**TINY)
    cfg.recompute = recompute
    port = LlamaForCausalLM(cfg, device="cpu")
    load_jax_params(port, weights)
    port.train()
    step = TrainStep(port, lambda out, a, k: out,
                     AdamW(1e-3, parameters=port.parameters()))
    _drive(step, torch.from_numpy)
    return step


def test_counters_and_report_keys_match_reference(reference):
    weights, want_counts, want_report = reference
    step = _port(weights)
    name = step.telemetry_name
    assert name.startswith("train_step:LlamaForCausalLM:")
    assert _counts(tmon, name) == want_counts == {
        "train_step_compiles": 1, "train_step_calls": 4,
        "train_step_fallback_recompiles": 1}
    report = tmon.step_report(name)
    assert set(report) == set(want_report)
    assert report["step"] == name and report["collective_census"] == []
    assert report["memory"] == {}          # the CPU has no allocator
    assert tmon.step_reports()[name] == report
    assert report["flops"] > 0 and report["bytes_accessed"] > 0
    assert tmon.analytic_mfu(name, 0.5) == pytest.approx(
        report["flops"] / 0.5 / tmon.device_peak_flops("cpu"))
    assert tmon.analytic_mfu("no such step", 0.5) is None


def test_recomputed_segments_count_twice(reference):
    weights = reference[0]
    plain = tmon.step_report(_port(weights).telemetry_name)
    rec = tmon.step_report(_port(weights, recompute=True).telemetry_name)
    # every decoder layer's forward runs again in the backward, up to the
    # last op whose saved tensors the backward needs (the down projection's
    # output is not one); the embedding, the head and the loss do not
    extra = rec["flops"] - plain["flops"]
    cfg = LlamaConfig.tiny(**TINY)
    tokens = 2 * 16
    per_layer = 2 * tokens * (cfg.hidden_size * (
        cfg.hidden_size + 2 * cfg.num_key_value_heads * cfg.head_dim
        + cfg.hidden_size) + 2 * cfg.hidden_size * cfg.intermediate_size)
    assert extra >= cfg.num_hidden_layers * per_layer
    assert extra < plain["flops"] / 2
