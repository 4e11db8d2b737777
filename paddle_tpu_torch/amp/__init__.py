"""Automatic mixed precision (counterpart of ``paddle_tpu/amp/__init__.py``,
Paddle's ``paddle.amp``).

O1 casts by op name, as the reference's dispatch hook does: every
functional of the port that the reference runs as a named op calls
:func:`cast_inputs` with that name first. Under ``auto_cast(level="O1")``
a white op's floating inputs go to the low dtype (``linear``,
``flash_attention`` and ``matmul`` among them, so K1 runs in bfloat16),
and a black op's low-dtype inputs back to float32 (``layer_norm``,
``softmax``, ``cross_entropy`` ...); other ops keep their inputs, and
PyTorch's promotion does the rest, as JAX's does in the reference.
``torch.autocast`` is not used: its lists are other lists.

O2 (:func:`decorate`) casts the models' floating parameters to the low
dtype and turns on the optimizers' ``multi_precision`` (float32 master
weights); ``auto_cast`` casts nothing at O2, as the reference's.

:class:`GradScaler` scales the loss, unscales the gradients with one
fused finite check and reads that one flag back a step, skipping the
step on a non-finite gradient, and moves the scale by the reference's
dynamic rule. The read-back makes it an eager-loop tool: it refuses to
run inside a CUDA graph capture.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "autocast", "decorate", "GradScaler", "amp_guard",
           "is_bfloat16_supported", "is_float16_supported",
           "white_list", "black_list", "cast_inputs"]

# the reference's O1 lists (Paddle's ``python/paddle/amp/amp_lists.py``)
WHITE_LIST = {"matmul", "linear", "conv1d", "conv2d", "conv3d", "bmm", "mm",
              "einsum", "flash_attention"}
BLACK_LIST = {"softmax", "log_softmax", "cross_entropy", "layer_norm",
              "batch_norm", "rms_norm", "mean", "sum", "exp", "log",
              "logsumexp", "erf", "pow", "cumsum"}

white_list = WHITE_LIST
black_list = BLACK_LIST

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _dtype(d):
    return _DTYPES[d] if isinstance(d, str) else d


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = "bfloat16"
        self.level = "O1"
        self.white = None      # the context's lists (None: the defaults)
        self.black = None


_state = _AmpState()


def amp_state():
    return _state


def cast_inputs(op_name, *xs):
    """The inputs of the op ``op_name`` as O1 casts them: a white op's
    floating tensors in the low dtype, a black op's low-dtype tensors in
    float32, anything else as it is. Outside ``auto_cast`` O1 it returns
    ``xs`` untouched."""
    if not _state.enabled or _state.level != "O1":
        return xs
    low = _dtype(_state.dtype)
    white = _state.white if _state.white is not None else WHITE_LIST
    black = _state.black if _state.black is not None else BLACK_LIST
    if op_name in white:
        return tuple(x.to(low) if isinstance(x, torch.Tensor)
                     and x.is_floating_point() else x for x in xs)
    if op_name in black:
        return tuple(x.float() if isinstance(x, torch.Tensor)
                     and x.dtype == low else x for x in xs)
    return xs


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """O1 inside: the white and black lists of the enclosing context (the
    defaults outside any) plus the custom ones; the enclosing state comes
    back on exit."""
    prev = (_state.enabled, _state.dtype, _state.level, _state.white,
            _state.black)
    base_w = _state.white if _state.white is not None else WHITE_LIST
    base_b = _state.black if _state.black is not None else BLACK_LIST
    _state.white = base_w | set(custom_white_list or ())
    _state.black = base_b | set(custom_black_list or ())
    _state.enabled = enable
    _state.dtype = dtype
    _state.level = level
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.white,
         _state.black) = prev


autocast = auto_cast
amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: each model's floating parameters and buffers in ``dtype``; each
    optimizer keeps float32 master weights (``multi_precision``, or
    ``master_weight`` when given). Returns what it was given, as the
    reference."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=_dtype(dtype))
            m._casted_by_pure_fp16 = True
    if optimizers is not None:
        single_opt = not isinstance(optimizers, (list, tuple))
        opt_list = [optimizers] if single_opt else list(optimizers)
        for opt in opt_list:
            opt._multi_precision = True if master_weight is None \
                else bool(master_weight)
        if single_model:
            return models, optimizers
        return model_list, opt_list
    return models if single_model else model_list


class GradScaler:
    """Dynamic loss scaling (Paddle's ``paddle.amp.GradScaler``):
    ``scale(loss)`` multiplies by the scale; ``step(opt)`` unscales the
    gradients (unless ``unscale_`` did) and steps unless one is
    non-finite; ``update()`` once an iteration moves the scale: times
    ``decr_ratio`` (not below 1) after ``decr_every_n_nan_or_inf`` bad
    steps, times ``incr_ratio`` after ``incr_every_n_steps`` good ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled_opts = set()
        self._stepped_opts = set()

    def scale(self, var):
        if not self._enable or self._scale == 1.0:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer`` by the scale in place
        and note whether any is non-finite: one fused check over the
        float32 / float16 ones (a check a tensor over bfloat16 ones), one
        flag read back."""
        if not self._enable:
            return
        if id(optimizer) in self._unscaled_opts:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update()")
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("GradScaler reads its found-inf flag back; "
                               "it cannot run inside a CUDA graph capture")
        self._unscaled_opts.add(id(optimizer))
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        found = False
        by_device = {}
        for g in grads:
            by_device.setdefault(g.device, []).append(g)
        flags = []
        for dev, gs in by_device.items():
            flag = torch.zeros((), device=dev)
            for dt in {g.dtype for g in gs}:
                group = [g for g in gs if g.dtype == dt]
                if dt in (torch.float32, torch.float16):
                    torch._amp_foreach_non_finite_check_and_unscale_(
                        group, flag,
                        torch.full((), 1.0 / self._scale, device=dev))
                else:       # the fused check takes no bfloat16
                    torch._foreach_mul_(group, 1.0 / self._scale)
                    flag.add_(torch.stack([torch.isfinite(g).all()
                                           for g in group]).logical_not()
                              .any())
            flags.append(flag)
        if flags:
            found = bool(torch.stack([f.cpu() for f in flags]).sum() > 0)
        # with several optimizers, one optimizer's inf vetoes every step
        # until update()
        self._found_inf = self._found_inf or found

    def step(self, optimizer):
        """Unscale (unless done) and step unless a gradient is
        non-finite; the scale moves in :meth:`update`."""
        if not self._enable:
            optimizer.step()
            return
        if id(optimizer) in self._stepped_opts:
            raise RuntimeError(
                "step() has already been called since the last update(). "
                "Call scaler.update() once per iteration after stepping "
                "every optimizer.")
        self._stepped_opts.add(id(optimizer))
        if self._scale != 1.0 and id(optimizer) not in self._unscaled_opts:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled_opts.clear()
        self._stepped_opts.clear()
        if not (self._enable and self._dynamic):
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, d):
        self._scale = d.get("scale", self._scale)
        self._good_steps = d.get("good_steps", 0)
        self._bad_steps = d.get("bad_steps", 0)


def is_bfloat16_supported(device=None):
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda" or dev is None \
            and torch.cuda.is_available():
        return torch.cuda.is_bf16_supported()
    return True


def is_float16_supported(device=None):
    return True
