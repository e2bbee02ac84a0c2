"""Training substrate: optimizer, loop, checkpointing, data pipeline."""

from .checkpoint import CheckpointManager  # noqa: F401
from .data import DataConfig, data_iterator, synthetic_batch  # noqa: F401
from .optimizer import AdamWConfig, adamw_update, init_opt_state, opt_state_pspecs  # noqa: F401
from .train_loop import TrainConfig, make_train_step, train  # noqa: F401
