"""``paddle.hapi`` of the port (counterpart of
``paddle_tpu/hapi/__init__.py``): ``Model`` and its callbacks."""
from . import callbacks
from .callbacks import (Callback, EarlyStopping, LRScheduler,
                        ModelCheckpoint, ProgBarLogger, VisualDL)
from .model import Model, summary_impl as summary

__all__ = ["callbacks", "Callback", "EarlyStopping", "LRScheduler",
           "ModelCheckpoint", "ProgBarLogger", "VisualDL", "Model",
           "summary"]
