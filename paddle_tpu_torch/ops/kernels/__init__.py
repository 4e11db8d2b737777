"""Hand-written CUDA kernels of the port (sources in
``paddle_tpu_torch/csrc``) with their plain PyTorch versions.

Every wrapper takes the plain version for tensors on the CPU and
launches its kernel for CUDA tensors (or raises); nothing falls back.
``launch_counts`` counts kernel launches per wrapper — a plain integer
bumped right after each successful launch, so a run can show that its
main path went through the kernels.

A kernel's output written through a raw pointer has no autograd history.
The wrappers whose kernels have no backward are decorated with
:func:`no_backward`, so their output never leaves the graph silently:
with gradients enabled and an input that requires them, the output
carries a node whose backward raises, on both devices (as
differentiating a ``pallas_call`` without a VJP fails in JAX). Under
``torch.no_grad()`` (the serving tick, ``generate()``) the check is all
they pay.

A wrapper whose kernel takes a per-stream scratch (the Hopper paged
attention body's split records, K3's partials) keeps it in a cache that
a larger call on the same stream replaces. :func:`hold_scratch` collects
every scratch tensor handed to a kernel inside it, so that a CUDA graph
captured there keeps the memory its kernels write for as long as it
lives.
"""
import contextlib
import functools

import torch

launch_counts = {"ragged_paged_attention": 0, "paged_decode_attention": 0,
                 "ragged_paged_attention_tree": 0,
                 "ragged_paged_attention_tree_int8": 0,
                 "paged_verify_attention": 0,
                 "ragged_paged_attention_int8": 0,
                 "paged_decode_attention_int8": 0,
                 "paged_verify_attention_int8": 0,
                 "paged_verify_attention_tree": 0,
                 "paged_verify_attention_tree_int8": 0,
                 "ragged_paged_attention_f32pool": 0,
                 "ragged_paged_attention_tree_f32pool": 0,
                 "paged_decode_attention_f32pool": 0,
                 "paged_verify_attention_f32pool": 0,
                 "paged_verify_attention_tree_f32pool": 0, "norm_matmul": 0,
                 "matmul_residual": 0, "flash_attention_fwd": 0,
                 "flash_attention_dq": 0, "flash_attention_dkv": 0,
                 "moe_gather_gmm_swiglu": 0, "moe_scatter_gmm": 0,
                 "moe_gmm": 0, "moe_gmm_t": 0, "moe_scatter_gmm_t": 0,
                 "moe_tgmm": 0, "flashmask_fwd": 0, "flashmask_dq": 0,
                 "flashmask_dkv": 0, "lora_gmm": 0, "lora_scatter_gmm": 0}


_HOLD = []      # the lists hold_scratch collects into


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@contextlib.contextmanager
def hold_scratch(sink: list):
    """Within the context, every per-stream scratch tensor that a wrapper
    hands its kernel is appended to ``sink`` (see the module docstring)."""
    _HOLD.append(sink)
    try:
        yield sink
    finally:
        _HOLD.pop()


def held(*tensors):
    """Record ``tensors`` (the scratch of a launch) in every active
    :func:`hold_scratch`; returns them as a tuple."""
    for sink in _HOLD:
        sink.extend(t for t in tensors if t is not None)
    return tensors


class _NoBackward(torch.autograd.Function):
    """Runs a kernel wrapper with the graph's inputs; its backward
    raises naming the kernel."""

    @staticmethod
    def forward(ctx, name, call, *inputs):
        ctx.name = name
        out = call()
        return tuple(out) if isinstance(out, list) else out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.name} has no backward: the kernel is a forward of the "
            "serving path, or a step of a backward that an autograd "
            "Function of the port owns")


def _tensors(values):
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (list, tuple)):
            yield from _tensors(v)


def no_backward(name):
    """Decorate a kernel wrapper that has no backward (see the module
    docstring); ``name`` names the kernel in the error."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if torch.is_grad_enabled():
                inputs = [t for t in _tensors([*args, *kwargs.values()])
                          if t.requires_grad]
                if inputs:
                    return _NoBackward.apply(
                        name, lambda: fn(*args, **kwargs), *inputs)
            return fn(*args, **kwargs)
        return call
    return wrap


__all__ = ["launch_counts", "reset_launch_counts", "no_backward",
           "hold_scratch", "held"]
