"""Optimizer + LR schedule factories.

Port of the JAX ``train/optim.py``: Adam(0.9, 0.999, eps 1e-8) with a
per-epoch StepLR ``lrate * gamma^floor(epoch / lrate_step)`` decay in
optimizer-step units.  As with optax, the rate of an update is
``schedule(step)`` where ``step`` counts the updates already done; the
trainer sets it before the steps it applies to (:func:`set_lr`).

On the card Adam is ``capturable``: its step count and its rate are
device tensors, so a training step captured in a CUDA graph (the trainer's
``make_epoch_fn``) reads the rate that :func:`set_lr` fills in and counts
its own steps on every replay; the eager step runs the same arithmetic.
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
    """Adam(0.9, 0.999, eps 1e-8) starting at ``lrate`` (step 0's rate).
    For parameters on the card it is capturable, with the rate an f32
    device tensor; on the CPU the rate is a float."""
    params = list(params)
    lrate = float(cfg["train"]["lrate"])
    dev = params[0].device if params else torch.device("cpu")
    if dev.type == "cuda":
        return torch.optim.Adam(params, lr=torch.tensor(lrate, device=dev),
                                betas=(0.9, 0.999), eps=1e-8, capturable=True)
    return torch.optim.Adam(params, lr=lrate, betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's rate; a device tensor is filled in place (no host
    sync, and a captured step reads the new value)."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
