"""Language-model substrate: the serving path (prefill, then decode) of the
dense decoder rows, with self-attention prefill through the flash kernel."""

from .factory import Model, build_model  # noqa: F401
from .transformer import Transformer, forward, init_caches, init_params, layer_plan  # noqa: F401
