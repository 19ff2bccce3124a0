"""Per-layer metrics from one ``torch.profiler`` trace of a steady block of
training steps.

The device's activity (kernels, copies, fills) is read from the trace's
events.  ``busy_s`` is the union of their intervals and ``window_s`` the
span from the first to the last; a gap in the union is time in which the
device ran nothing.  Kernels are grouped by name, as
``utils/profiling.py::device_kernels`` of the program groups them.

A per-layer metric is a file ``metrics/<name>.json`` naming one of the
readers of :data:`READERS` and its arguments, or ``metrics/<name>.py``
with a ``read(ctx) -> float | None``.  A reader that finds nothing to read
returns None, and the metric is left out of the result.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

import counts

TOP = 10
# Prefix of the ranges the benchmark marks around its own host work.
ANNOTATION = "portbench."


class Trace:
    """The device's activity in a traced block of ``steps`` steps."""

    def __init__(self, prof, steps: int):
        dev, host = [], []
        for ev in prof.events():
            rng = ev.time_range
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if getattr(ev, "is_user_annotation", False) or ev.name.startswith(ANNOTATION):
                    continue    # the device's copy of a host range: no device work
                dev.append((ev.name, rng.start, rng.end))
            elif ev.device_type == torch.autograd.DeviceType.CPU:
                host.append((ev.name, rng.start, rng.end))
        self.steps = steps
        self.kernels: Dict[str, float] = {}
        for name, start, end in dev:
            self.kernels[name] = self.kernels.get(name, 0.0) + (end - start) * 1e-6
        self.host = host
        self.gaps: List[Tuple[float, float]] = []
        busy = 0.0
        spans = sorted((s, e) for _, s, e in dev)
        if spans:
            cur_s, cur_e = spans[0]
            for s, e in spans[1:]:
                if s > cur_e:
                    busy += cur_e - cur_s
                    self.gaps.append((cur_e, s))
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
            self.window_s = (spans[-1][1] - spans[0][0]) * 1e-6
        else:
            self.window_s = 0.0
        self.busy_s = busy * 1e-6

    def seconds_of(self, patterns) -> Optional[float]:
        """Device seconds of the kernels whose name holds any of
        ``patterns``; None where none ran."""
        hit = [s for name, s in self.kernels.items() if any(p in name for p in patterns)]
        return sum(hit) if hit else None

    def host_at(self, t: float) -> str:
        """The innermost host event running at ``t`` (us)."""
        best = None
        for name, s, e in self.host:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "no host event"

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[name[:120], s] for name, s in ops],
                "idle_gaps": [[self.host_at(0.5 * (s + e)), (e - s) * 1e-6]
                              for s, e in gaps]}


def _idle_share(ctx, **_) -> Optional[float]:
    tr = ctx["trace"]
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def _kernel_ms(ctx, kernels, **_) -> Optional[float]:
    tr = ctx["trace"]
    s = tr.seconds_of(kernels)
    return None if s is None else 1e3 * s / tr.steps


def _mfu(ctx, work, **_) -> Optional[float]:
    tr = ctx["trace"]
    flop = ctx["work"].get(work)
    if flop is None or tr.window_s <= 0:
        return None
    step_s = tr.window_s / tr.steps
    return 100.0 * flop / (step_s * counts.PEAKS["f32_flop_per_s"])


def _roofline(ctx, kernels, work, **_) -> Optional[float]:
    tr = ctx["trace"]
    s = tr.seconds_of(kernels)
    w = ctx["work"].get(work)
    if s is None or w is None:
        return None
    return 100.0 * counts.least_seconds(w) / (s / tr.steps)


READERS: Dict[str, Callable] = {
    "idle_share": _idle_share,
    "kernel_ms": _kernel_ms,
    "mfu": _mfu,
    "roofline": _roofline,
}


def load_reader(metrics_dir: Path, name: str) -> Callable:
    """The reader of metric ``name``: ``metrics/<name>.py``'s ``read`` or
    the reader that ``metrics/<name>.json`` names, with its arguments."""
    py = metrics_dir / f"{name}.py"
    if py.is_file():
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", py)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
    with open(metrics_dir / f"{name}.json") as f:
        desc = json.load(f)
    fn = READERS[desc["reader"]]
    return lambda ctx: fn(ctx, **desc)
