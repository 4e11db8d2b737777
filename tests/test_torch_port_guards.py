"""Guards of the PyTorch port's boundaries: ``paddle_tpu_torch``,
``tools/*.py`` and ``chip_smoke.py`` import neither ``jax`` nor anything
of ``paddle_tpu`` (checked on the source's AST and in a fresh
interpreter), and the port's entry points run on CUDA unless the caller
passes ``device="cpu"`` — without a GPU they raise instead of dropping
to the CPU."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.framework import generator, resolve_device
from paddle_tpu_torch.framework.place import default_device
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.qwen2 import Qwen2Config, Qwen2ForCausalLM
from paddle_tpu_torch.optimizer import AdamW

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "flax", "optax")


def _port_sources():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    return files + sorted((ROOT / "tools").glob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_sources_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    for want in ("paddle_tpu_torch/models/llama.py",
                 "paddle_tpu_torch/inference/serving.py",
                 "paddle_tpu_torch/ops/kernels/decode_fused.py",
                 "paddle_tpu_torch/ops/kernels/ragged_paged_attention.py",
                 "paddle_tpu_torch/ops/kernels/flash_attention.py",
                 "paddle_tpu_torch/ops/flash_attention.py",
                 "paddle_tpu_torch/optimizer/optimizer.py",
                 "paddle_tpu_torch/jit/__init__.py",
                 "paddle_tpu_torch/ops/kernels/paged_attention.py",
                 "paddle_tpu_torch/generation/__init__.py",
                 "paddle_tpu_torch/generation/speculative.py",
                 "paddle_tpu_torch/ops/kernels/moe_gmm.py",
                 "paddle_tpu_torch/distributed/moe.py",
                 "paddle_tpu_torch/models/qwen2_moe.py",
                 "paddle_tpu_torch/models/qwen2.py",
                 "paddle_tpu_torch/models/deepseek_moe.py",
                 "paddle_tpu_torch/ops/kernels/flashmask.py",
                 "paddle_tpu_torch/nn/functional/common.py",
                 "paddle_tpu_torch/nn/functional/flash_attention.py",
                 "paddle_tpu_torch/nn/functional/activation.py",
                 "paddle_tpu_torch/distributed/fleet/mp_layers.py",
                 "paddle_tpu_torch/models/gpt.py",
                 "paddle_tpu_torch/monitor/registry.py",
                 "paddle_tpu_torch/monitor/tracing.py",
                 "paddle_tpu_torch/monitor/health.py",
                 "paddle_tpu_torch/monitor/accounting.py",
                 "paddle_tpu_torch/monitor/digest.py",
                 "chip_smoke.py"):
        assert want in names
    for cu in ("ragged_paged_attention", "paged_decode_attention",
               "norm_matmul", "matmul_residual", "flash_attention_fwd",
               "flash_attention_bwd", "moe_gmm", "flashmask_fwd",
               "flashmask_bwd"):
        assert (ROOT / "paddle_tpu_torch" / "csrc" / f"{cu}.cu").exists()


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [(m, line) for m, line in _imported_roots(path)
           if m in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_fresh_interpreter_import_pulls_in_no_jax():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.ops.kernels."
            "decode_fused, paddle_tpu_torch.ops.kernels.flash_attention, "
            "paddle_tpu_torch.ops.kernels.flashmask, "
            "paddle_tpu_torch.nn.functional, "
            "paddle_tpu_torch.ops.kernels.paged_attention, "
            "paddle_tpu_torch.generation.speculative, "
            "paddle_tpu_torch.inference, paddle_tpu_torch.jit, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.models, "
            "paddle_tpu_torch.models.gpt, "
            "paddle_tpu_torch.distributed.fleet.mp_layers, "
            "paddle_tpu_torch.nn.functional.activation, "
            "paddle_tpu_torch.monitor.registry, "
            "paddle_tpu_torch.monitor.tracing, "
            "paddle_tpu_torch.monitor.health, "
            "paddle_tpu_torch.monitor.accounting; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda():
    assert default_device() == torch.device("cuda")
    assert paddle_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_gpu(no_gpu):
    cfg = LlamaConfig.tiny(vocab=64, hidden=64, layers=1, heads=2,
                           kv_heads=1, ffn=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        generator(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Qwen2ForCausalLM(Qwen2Config.tiny(vocab=64, hidden=64, layers=1,
                                          heads=2, kv_heads=1, ffn=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, ServingConfig(num_slots=1, max_model_len=32))
    # generate() runs on the model's device: the CPU model decodes there
    out, _ = model.generate(np.ones((1, 3), np.int64), max_new_tokens=2)
    assert out.device.type == "cpu" and tuple(out.shape) == (1, 2)
    eng = ServingEngine(model, ServingConfig(num_slots=1, max_model_len=32),
                        device="cpu")
    assert eng.device == torch.device("cpu")
    assert params_from_jax({"w": np.zeros(2, np.float32)},
                           device="cpu")["w"].device.type == "cpu"


def test_engine_refuses_a_model_on_another_device():
    cfg = LlamaConfig.tiny(vocab=64, hidden=64, layers=1, heads=2,
                           kv_heads=1, ffn=64)
    model = LlamaForCausalLM(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(model, ServingConfig(num_slots=1,
                                               max_model_len=32))
    else:
        with pytest.raises(ValueError, match="device"):
            ServingEngine(model, ServingConfig(num_slots=1,
                                               max_model_len=32))


def test_training_entry_points_raise_without_gpu(no_gpu):
    """A model on the default device cannot be built without a GPU, so
    neither can its optimizer or TrainStep; on ``device="cpu"`` the same
    calls run the plain path."""
    cfg = LlamaConfig.tiny(vocab=64, hidden=128, layers=1, heads=2,
                           kv_heads=1, ffn=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainStep(LlamaForCausalLM(cfg), lambda out, a, k: out,
                  AdamW(1e-4, parameters=LlamaForCausalLM(cfg).parameters()))
    model = LlamaForCausalLM(cfg, device="cpu")
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, lambda out, a, k: out, opt)
    assert step.device == torch.device("cpu")
    ids = np.zeros((1, 8), np.int64)
    assert np.isfinite(float(step(ids, ids)))


def test_gpt_and_its_layers_raise_without_gpu(no_gpu):
    """GPT and the layers it adds (LayerNorm, the degree-1 tensor-parallel
    layers) default to CUDA and raise without a GPU; ``device="cpu"``
    builds them, and the model generates there."""
    from paddle_tpu_torch.distributed.fleet import (ColumnParallelLinear,
                                                    RowParallelLinear,
                                                    VocabParallelEmbedding)
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import LayerNorm
    cfg = GPTConfig.tiny(vocab=64, hidden=64, layers=1, heads=1)
    for build in (lambda **k: GPTForCausalLM(cfg, **k),
                  lambda **k: LayerNorm(8, **k),
                  lambda **k: ColumnParallelLinear(8, 8, **k),
                  lambda **k: RowParallelLinear(8, 8, **k),
                  lambda **k: VocabParallelEmbedding(8, 4, **k)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        assert all(p.device.type == "cpu"
                   for p in build(device="cpu").parameters())
    model = GPTForCausalLM(cfg, device="cpu")
    out, _ = model.generate(np.ones((1, 3), np.int64), max_new_tokens=2)
    assert out.device.type == "cpu" and tuple(out.shape) == (1, 2)
