"""Optimizer + LR schedule factories.

Port of the JAX ``train/optim.py``: Adam(0.9, 0.999, eps 1e-8) with a
per-epoch StepLR ``lrate * gamma^floor(epoch / lrate_step)`` decay in
optimizer-step units.  As with optax, the rate of an update is
``schedule(step)`` where ``step`` counts the updates already done; the
trainer sets it before every ``optimizer.step()`` (:func:`set_lr`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable

import torch


def make_lr_schedule(cfg: Dict[str, Any], steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """lr(step) = lrate * gamma ^ floor((step // steps_per_epoch) / lrate_step)."""
    lrate = float(cfg["train"]["lrate"])
    gamma = float(cfg["train"]["lrate_gamma"])
    lrate_step = int(cfg["train"]["lrate_step"])

    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        return lrate * gamma ** math.floor(epoch / lrate_step)

    return schedule


def make_optimizer(cfg: Dict[str, Any], params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Adam:
    """Adam(0.9, 0.999, eps 1e-8) starting at ``lrate`` (step 0's rate)."""
    return torch.optim.Adam(params, lr=float(cfg["train"]["lrate"]),
                            betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
