"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework/io.py``).

A checkpoint is a pickle of the object with every tensor as a numpy
array (Paddle's ``.pdparams`` / ``.pdopt`` layout), so the two packages
read each other's files. A bfloat16 tensor is written as float32 (numpy
has no bfloat16 of its own); a bfloat16 array read from a file (the
reference writes ``ml_dtypes`` arrays) comes back as a bfloat16 tensor.
``load`` returns CPU tensors (``return_numpy=True``: the arrays), which
``set_state_dict`` copies onto a layer's device. Files written by real
PaddlePaddle load without it: references to ``paddle.*`` classes
resolve to a stub that keeps their payload.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _to_tensor(obj):
    if isinstance(obj, np.ndarray):
        if obj.dtype.name == "bfloat16":
            return torch.from_numpy(np.ascontiguousarray(obj).view(
                np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(obj))
    if isinstance(obj, dict):
        return {k: _to_tensor(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensor(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_numpy(obj), f, protocol=protocol)


class _PaddleCompatUnpickler(pickle.Unpickler):
    """Reads real PaddlePaddle pickles: ``paddle.*`` classes become a stub
    keeping their constructor arguments and state (Paddle 2.x stores its
    tensors as numpy arrays, which need no Paddle code)."""

    class _Stub:
        def __init__(self, *a, **k):
            self.args = a

        def __setstate__(self, state):
            self.state = state

    def find_class(self, module, name):
        if module.split(".")[0] in ("paddle", "paddle_tpu_missing"):
            return _PaddleCompatUnpickler._Stub
        return super().find_class(module, name)


def load(path, return_numpy=False, **configs):
    with open(path, "rb") as f:
        try:
            obj = pickle.load(f)
        except (ModuleNotFoundError, AttributeError):
            f.seek(0)
            obj = _PaddleCompatUnpickler(f).load()
    return obj if return_numpy else _to_tensor(obj)
