"""Language-model substrate: the serving path (prefill, then decode) of
every reference row, with self-attention prefill through the flash kernel."""

from .factory import Model, build_model, chunked_ce_loss, param_pspecs  # noqa: F401
from .transformer import (  # noqa: F401
    Transformer,
    encode,
    forward,
    init_caches,
    init_params,
    layer_plan,
)
