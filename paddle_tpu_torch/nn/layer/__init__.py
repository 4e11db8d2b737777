"""The port's layers (counterpart of ``paddle_tpu/nn/layer/``)."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .container import *  # noqa: F401,F403
from .container import __all__ as _container
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .layers import HookRemoveHelper, Layer, create_parameter
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _transformer

__all__ = (["HookRemoveHelper", "Layer", "create_parameter"] + _activation
           + _common + _container + _conv + _loss + _norm + _pooling
           + _transformer)
