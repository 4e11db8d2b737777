from .place import default_device, resolve_device
from .random import default_generator, generator, seed

__all__ = ["default_device", "resolve_device", "default_generator",
           "generator", "seed"]
