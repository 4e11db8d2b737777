"""``paddle.nn.functional`` of the port (counterpart of
``paddle_tpu/nn/functional/``): activations, losses, norms, convolutions
and pools, the common functionals and the attention entry points."""
from . import flash_attention
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .conv_pool import *  # noqa: F401,F403
from .conv_pool import __all__ as _conv_pool
from .flash_attention import flashmask_attention, scaled_dot_product_attention
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm

__all__ = (["flash_attention", "flashmask_attention",
            "scaled_dot_product_attention"]
           + _activation + _common + _conv_pool + _loss + _norm)
