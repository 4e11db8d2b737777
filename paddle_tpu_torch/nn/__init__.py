"""``paddle.nn`` of the port (counterpart of ``paddle_tpu/nn/``): the
``Layer`` base and containers, the common, conv, pooling, norm (layer,
RMS, batch, instance, group, local-response, spectral), activation, loss
and transformer layers, ``ParamAttr`` and the initializers, gradient
clipping and ``functional``, under the reference's names. rnn and the
resampling and padding layers are not ported yet (ROADMAP Queue 1 item
9)."""
from . import functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from .param_attr import ParamAttr

__all__ = (["functional", "initializer", "ClipGradByGlobalNorm",
            "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
            "clip_grad_value_", "ParamAttr"] + _layers)
