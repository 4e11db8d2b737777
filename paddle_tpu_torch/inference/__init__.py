"""Serving (counterpart of ``paddle_tpu/inference``, core engine)."""
from .serving import QueueShedError, ServingConfig, ServingEngine

__all__ = ["ServingConfig", "ServingEngine", "QueueShedError"]
