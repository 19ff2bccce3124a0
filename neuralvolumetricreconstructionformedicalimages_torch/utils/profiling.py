"""Timing and tracing: CUDA events on the card, the host clock on the CPU.

``StepTimer.tick()`` marks a step boundary in the device stream without
waiting for the device; ``StepTimer.step_ms()`` waits once and returns the
times between consecutive ticks.  On the card these are device-stream
times (they include any gap in which the host left the stream idle).

``time_fn`` times a function call by call (port of the JAX
``utils/profiling.py::time_fn``, with CUDA events in place of JAX's host
fence); ``profiler_trace`` captures a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
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


def _on_cuda(out) -> bool:
    """True when any tensor in ``out`` (nested lists, tuples, dicts) lies on
    a CUDA device."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_cuda(o) for o in out)
    return False


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            **kwargs) -> Dict[str, float]:
    """Time ``fn(*args, **kwargs)`` call by call (seconds).

    The first call (kernel builds, caches, allocator growth) is reported
    as ``compile_s``, by the host clock up to a device synchronise.  When
    it returns a tensor on the card, every later call is timed by CUDA
    events recorded around it on the current stream; otherwise by the host
    clock.  Returns ``compile_s``, ``mean_s``, ``median_s``, ``min_s``,
    ``std_s`` and ``iters``, as the JAX version does.
    """
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    cuda = _on_cuda(out)
    if cuda:
        torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    del out
    for _ in range(max(0, warmup - 1)):
        fn(*args, **kwargs)
    times = []
    if cuda:
        marks = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            marks.append((start, end))
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) / 1e3 for s, e in marks]
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    t = np.asarray(times)
    return {
        "compile_s": compile_s,
        "mean_s": float(t.mean()),
        "median_s": float(np.median(t)),
        "min_s": float(t.min()),
        "std_s": float(t.std()),
        "iters": iters,
    }


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the block into
    ``logdir/trace.json`` (Chrome trace format); the card's kernels are
    traced when one is present.  Yields the profiler, whose
    ``key_averages()`` sums time by operator; a no-op yielding ``None``
    when ``logdir`` is None."""
    if logdir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
