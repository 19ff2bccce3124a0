"""Training subsystem: the epoch function (a captured CUDA graph of the
step, replayed step by step, on the card) + orchestrator + CLI."""

from .optim import make_lr_schedule, make_optimizer  # noqa: F401
from .trainer import (  # noqa: F401
    Trainer,
    build_model,
    make_epoch_fn,
    make_loss_fn,
    make_train_step,
)
