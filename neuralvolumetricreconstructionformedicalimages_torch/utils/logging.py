"""Experiment logging: a machine-readable ``metrics.jsonl`` always, and
TensorBoard scalars/images when ``torch.utils.tensorboard`` imports."""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Any, Dict

import numpy as np


class ExperimentLogger:
    def __init__(self, logdir: str, enable_tensorboard: bool = True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(osp.join(logdir, "metrics.jsonl"), "a", buffering=1)
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(logdir)

    def add_scalar(self, tag: str, value: Any, step: int) -> None:
        v = float(np.asarray(value))
        self._jsonl.write(json.dumps(
            {"t": time.time(), "step": step, "tag": tag, "value": v}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, v, step)

    def add_scalars(self, values: Dict[str, Any], step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.add_scalar(prefix + k, v, step)

    def add_image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        """img_hwc: [H, W, C] float in [0, 1]."""
        if self._tb is not None:
            self._tb.add_image(tag, np.asarray(img_hwc), step, dataformats="HWC")

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, text, step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
