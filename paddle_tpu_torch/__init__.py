"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

It serves causal LMs (Llama, Qwen2, the MoE families and GPT) through
the ragged serving tick, generates with ``model.generate()`` (dense
cache, paged cache, speculative decoding with an n-gram drafter, a
draft model or a token tree; beam and group-beam search; an exported
generation artifact) and trains them through ``jit.TrainStep``
(or ``loss.backward()`` + ``opt.step()``) with Paddle's optimizers
and schedulers, and activation recompute; it pretrains and fine-tunes
BERT on Paddle's ``nn`` layers (``nn.Layer``, the containers,
initializers, activations, losses and the transformer stack) under
``amp`` O1 / O2 with a ``GradScaler``; it trains, evaluates and predicts
the vision models (LeNet, ResNet, VGG, AlexNet, MobileNetV2 on the conv,
pooling and batch-norm layers) through ``paddle.Model`` over ``io``'s
``DataLoader``, ``metric`` and ``vision``'s datasets, and saves and
loads Paddle checkpoints; on an NVIDIA
Hopper GPU: hand-written CUDA kernels for ragged, decode
and verify paged attention, RMSNorm -> projections, projection ->
residual, and flash attention's forward, dq and dk/dv passes (sources in
``paddle_tpu_torch/csrc``, built with nvcc at first use), plain PyTorch
for the rest. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, where every kernel's plain PyTorch version runs
instead. The package imports neither ``jax`` nor ``paddle_tpu``.
"""
import sys as _sys

from . import (amp, distributed, framework, generation, hapi, inference, io,
               jit, metric, models, nn, ops, optimizer, regularizer, static,
               vision)
from .convert import load_jax_params, params_from_jax
from .framework import generator, resolve_device, seed
from .framework.io import load, save
from .hapi import Model, callbacks, summary

_sys.modules[__name__ + ".callbacks"] = callbacks

__version__ = "0.1.0"

__all__ = ["amp", "distributed", "framework", "generation", "hapi",
           "inference", "io", "jit", "metric", "models", "nn", "ops",
           "optimizer", "regularizer", "static", "vision", "Model",
           "callbacks", "summary", "save", "load", "load_jax_params",
           "params_from_jax", "generator", "resolve_device", "seed"]
