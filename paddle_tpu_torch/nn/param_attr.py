"""``paddle.ParamAttr`` (counterpart of ``paddle_tpu/nn/param_attr.py``):
what :meth:`Layer.create_parameter` reads to make a parameter — its
Paddle name (the parameter's ``param_name``, which the optimizers' state
keys and AdamW's ``apply_decay_param_fun`` read), its initializer, its
``learning_rate`` (kept as ``optimize_attr``) and whether it trains."""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None or a ParamAttr as it is; a string names the parameter;
        False stays False (no parameter); an initializer becomes the
        attribute's initializer."""
        if attr is None or isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        from .initializer import Initializer
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        return ParamAttr()
