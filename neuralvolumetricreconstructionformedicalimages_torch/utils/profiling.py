"""Step timing: CUDA events on the card, the host clock on the CPU.

``StepTimer.tick()`` marks a step boundary in the device stream without
waiting for the device; ``StepTimer.step_ms()`` waits once and returns the
times between consecutive ticks.  On the card these are device-stream
times (they include any gap in which the host left the stream idle).
"""

from __future__ import annotations

import time
from typing import List

import torch


class StepTimer:
    """Per-step durations from marks taken at step boundaries."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self._marks: List = []

    def tick(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())

    def step_ms(self) -> List[float]:
        """Milliseconds between consecutive ticks (waits for the device)."""
        m = self._marks
        if self.cuda and m:
            m[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(m[:-1], m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m[:-1], m[1:])]

    def reset(self) -> None:
        self._marks = []


def cuda_time_ms(fn, *args, warmup: int = 3, iters: int = 20) -> float:
    """Mean milliseconds per call of ``fn(*args)`` on the card, from CUDA
    events around ``iters`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
