"""``paddle.static`` of the port (counterpart of
``paddle_tpu/static/__init__.py``): ``InputSpec`` only, the shape and
dtype of a model input that ``hapi.Model`` takes. The static-graph
``Program`` / ``Executor`` and the mode switches are not ported yet
(ROADMAP Queue 1 item 12)."""
from __future__ import annotations

__all__ = ["InputSpec"]


class InputSpec:
    """``paddle.static.InputSpec``: a shape (``None`` / -1 for a free
    dim), a dtype name and a name."""

    def __init__(self, shape=None, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = list(shape) if shape is not None else None
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")
