"""Training subsystem: per-step PyTorch loop + orchestrator + CLI."""

from .optim import make_lr_schedule, make_optimizer  # noqa: F401
from .trainer import Trainer, build_model, make_loss_fn  # noqa: F401
