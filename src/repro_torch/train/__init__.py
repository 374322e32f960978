"""Training: AdamW over fp32 master parameters, the train step,
checkpoints and the supervisor.  Port of ``repro.train``."""
from .optim import adamw_init, adamw_update, zero1_shardings
from .step import TrainConfig, make_train_step, init_train_state

__all__ = ["adamw_init", "adamw_update", "zero1_shardings", "TrainConfig",
           "make_train_step", "init_train_state"]
