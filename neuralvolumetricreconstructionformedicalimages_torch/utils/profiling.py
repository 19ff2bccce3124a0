"""Timing and tracing: CUDA events on the card, the host clock on the CPU.

``StepTimer.tick()`` marks a step boundary in the device stream without
waiting for the device; ``StepTimer.step_ms()`` waits once and returns the
times between consecutive ticks.  On the card these are device-stream
times (they include any gap in which the host left the stream idle).

``time_fn`` times a function call by call (port of the JAX
``utils/profiling.py::time_fn``, with CUDA events in place of JAX's host
fence).

``traced_device_ms`` sums the device time of what a call ran;
``device_times`` times a call on the card without the host's launch path:
events around one call bracket ctypes, argument checks and allocation as
well as the kernel, which for a kernel of tens of microseconds may time
the host.

Layer ranges
------------

``layer_range(name)`` brackets one layer of the training step.  A range
has two parts:

- the host part, a ``torch.profiler.record_function("nvr.<name>")``
  range, opened only while a profiler runs (otherwise the call costs a
  flag read and returns a shared null context);
- the device part, for the names of :data:`RANGES`: a range mark, one
  kernel (``csrc/range_mark.cu``) that reads the device's clock and
  starts the range's device interval, which the next mark ends.  Marks
  are launched only inside a :func:`marking` block.  ``range_mark(name)``
  launches the mark alone (the backward's boundaries, which have no host
  range of their own).

The leaf ranges of :data:`RANGES` tile the main path's step in order; the
step's end mark, launched when the :func:`marking` block closes, charges
each interval between two marks to the range the first one started, and
the interval from one step's end to the next step's first mark to
``step.io``.  The sums live in one small int64 buffer a device
(:func:`range_buffer`), allocated once, outside every CUDA graph's pool,
since a graph bakes in its address.  On the CPU a mark reads the host
clock instead and charges the same way.

``train/trainer.py::_GraphedStep`` captures the training step twice on
the card: the plain graph, with no mark, and a marked twin that it
replays instead while a profiler runs or inside a :func:`ranges` block.
``range_totals()`` reads what the marked replays charged since the last
switch from plain to marked replays.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

# The device ranges, in the order in which they tile the main path's step
# (``encode`` stands for the four ``encode.*`` ranges on the encoder's
# other paths; the XOR path marks ``encode.index``, ``encode.gather``,
# ``backward.encode.sort`` and ``backward.encode.bucket``); ``step.io``
# takes the time between steps.
RANGES = ("batch", "sample", "encode.index", "encode.sort", "encode.permute",
          "encode.gather", "encode", "mlp", "render", "loss", "backward.render",
          "backward.mlp", "backward.encode.permute", "backward.encode.sort",
          "backward.encode.bucket", "backward.encode.unroll", "optim", "step.io")
PREFIX = "nvr."
# Marks a step may launch, its end mark included.
MAX_MARKS = 64
MARK_KERNEL = "range_mark_kernel"

_IDS = {name: i for i, name in enumerate(RANGES)}
_IO = _IDS["step.io"]
_N = len(RANGES)
_TOTALS = 2 * MAX_MARKS          # offset of the per-range sums in a buffer
_BUFFERS: Dict[torch.device, torch.Tensor] = {}
_MARKER = None                   # the open ``marking`` block's marker
_RANGES_ON = 0                   # depth of open ``ranges`` blocks
_NULL = contextlib.nullcontext()


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


def device_kernels(prof) -> Tuple[Dict[str, Tuple[float, int]], Tuple[float, int]]:
    """The device work of a finished ``torch.profiler`` run: ({name: (device
    ms, launches)} of every kernel and memset but the range marks, (device
    ms, launches) of the range marks), so that sums over the first stay
    those of the step's own work."""
    out, marks = {}, (0.0, 0)
    for ev in prof.key_averages():
        if getattr(ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            if MARK_KERNEL in ev.key:
                marks = (marks[0] + dev_us / 1e3, marks[1] + ev.count)
            else:
                out[ev.key] = (dev_us / 1e3, ev.count)
    return out, marks


def traced_device_ms(run: Callable):
    """``run()`` under ``torch.profiler``: (its result, the device ms of
    every kernel and memset it ran but the range marks, those kernels as
    :func:`device_kernels` gives them, the range marks' device ms) -- for a
    CUDA graph's replays, the kernels that actually ran (a graphed step
    replays its marked twin under a profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = run()
        torch.cuda.synchronize()
    kernels, marks = device_kernels(prof)
    return out, sum(ms for ms, _ in kernels.values()), kernels, marks[0]


def device_busy(prof) -> Tuple[float, float]:
    """(busy ms, window ms) of the device in a finished ``torch.profiler``
    run: the union of its kernels, copies and fills, and the span from the
    first one's start to the last one's end (the device copies of host
    ranges, user annotations, are no device work)."""
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and not ev.is_user_annotation)
    return union_ms(spans), (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0


def union_ms(spans) -> float:
    """Milliseconds covered by the union of sorted (start, end) spans in us."""
    busy, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e3


def device_times(fn: Callable, iters: int = 50, calls: int = 200) -> Dict:
    """Device time per call of ``fn`` (which launches work on the card), in
    milliseconds, two ways:

    - ``profiler_ms``: ``torch.profiler``'s device time of every kernel and
      memset the call launches, summed over ``iters`` calls, per call;
      ``parts`` gives it by kernel name (range marks left out);
    - ``back_to_back_ms``: ``calls`` calls between one pair of CUDA events,
      per call; the host runs ahead, so the device does not wait on it.
    """
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = {k: ms / iters for k, (ms, _) in device_kernels(prof)[0].items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return {"profiler_ms": sum(parts.values()), "parts": parts,
            "back_to_back_ms": start.elapsed_time(end) / calls}


# --------------------------------------------------------------------------
# Layer ranges
# --------------------------------------------------------------------------

def _profiler_on() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


class _LayerRange:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if _profiler_on():
            self.rf = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        if _MARKER is not None and self.name in _IDS:
            _MARKER.mark(_IDS[self.name])

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        return False


def layer_range(name: str):
    """The layer range ``name`` as a context manager: the host range
    ``nvr.<name>`` while a profiler runs, and, for a name of
    :data:`RANGES` inside a :func:`marking` block, a mark at its start
    (none where that range is already the one running)."""
    if _MARKER is None and not _profiler_on():
        return _NULL
    return _LayerRange(name)


def range_mark(name: str) -> None:
    """Start the device range ``name`` (of :data:`RANGES`) here, inside a
    :func:`marking` block; nothing outside one."""
    if _MARKER is not None:
        _MARKER.mark(_IDS[name])


def mark_on_grad(t: torch.Tensor, name: str) -> None:
    """Inside a :func:`marking` block, start the device range ``name`` when
    the backward reaches ``t``, i.e. once ``t``'s gradient is complete."""
    if _MARKER is not None and t.requires_grad:
        t.register_hook(lambda _grad: range_mark(name))


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def range_buffer(device) -> torch.Tensor:
    """The device's range buffer (int64: the step's stamps and range ids,
    then the sums, see ``csrc/range_mark.cu``), made zero on first use.
    Call it first outside any CUDA graph capture: a graph bakes in its
    address, and a buffer made during a capture would live in the graph's
    pool."""
    dev = _device(device)
    buf = _BUFFERS.get(dev)
    if buf is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the range buffer must be made before a CUDA graph "
                               "capture (range_buffer(device) outside it)")
        buf = torch.zeros(_TOTALS + 2 * _N + 2, dtype=torch.int64, device=dev)
        _BUFFERS[dev] = buf
    return buf


def reset_ranges(device) -> None:
    """Zero the device's sums, on its current stream."""
    range_buffer(device)[_TOTALS:].zero_()


def range_totals(device=None) -> Dict:
    """What the marks on ``device`` (default: the current card, else the
    CPU) charged since the last reset: ``{"steps": marked steps,
    "device_ms": {range: ms summed over the steps}, "hits": {range:
    intervals}}``, every name of :data:`RANGES` present.  Waits for the
    device."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    buf = _BUFFERS.get(_device(device))
    vals = [0] * (2 * _N + 2) if buf is None else buf[_TOTALS:].tolist()
    return {"steps": int(vals[2 * _N + 1]),
            "device_ms": {r: vals[i] / 1e6 for i, r in enumerate(RANGES)},
            "hits": {r: int(vals[_N + i]) for i, r in enumerate(RANGES)}}


@contextlib.contextmanager
def ranges():
    """Within the block, graphed training steps replay their marked twin, so
    that :func:`range_totals` reads the ranges without a profiler."""
    global _RANGES_ON
    _RANGES_ON += 1
    try:
        yield
    finally:
        _RANGES_ON -= 1


def ranges_on() -> bool:
    """True inside a :func:`ranges` block or while a profiler runs: the
    times when a graphed step replays its marked twin."""
    return _RANGES_ON > 0 or _profiler_on()


class _Marker:
    """The marks of one step on one device: slot ``n`` is the next mark."""

    def __init__(self, device: torch.device):
        self.buf = range_buffer(device)
        self.cuda = self.buf.is_cuda
        self.host = None if self.cuda else self.buf.numpy()
        self.n = 0
        self.current = None

    def mark(self, rid: int) -> None:
        if rid == self.current:
            return
        if self.n >= MAX_MARKS - 1:
            raise RuntimeError(f"a step launched more than {MAX_MARKS - 1} range marks")
        self._stamp(rid, end=False)
        self.n += 1
        self.current = rid

    def end(self) -> None:
        if self.n:
            self._stamp(_IO, end=True)

    def _stamp(self, rid: int, end: bool) -> None:
        if self.cuda:
            from ..ops import _build

            _build.LAUNCHES["range_mark"] += 1
            _build.launch("nvr_range_mark", self.buf.device, self.buf.data_ptr(),
                          self.n, rid, MAX_MARKS, _N, int(end))
        else:
            charge(self.host, self.n, rid, end, time.perf_counter_ns())


def charge(h: np.ndarray, slot: int, rid: int, end: bool, now: int) -> None:
    """The range mark of ``csrc/range_mark.cu`` on a host copy of the
    buffer ``h``, at the clock reading ``now`` (ns)."""
    h[slot] = now
    h[MAX_MARKS + slot] = rid
    if not end:
        return
    ns, hits, tail = _TOTALS, _TOTALS + _N, _TOTALS + 2 * _N
    for j in range(slot):
        r = int(h[MAX_MARKS + j])
        h[ns + r] += h[j + 1] - h[j]
        h[hits + r] += 1
    if h[tail]:
        h[ns + _IO] += h[0] - h[tail]
        h[hits + _IO] += 1
    h[tail] = now
    h[tail + 1] += 1


@contextlib.contextmanager
def marking(device):
    """Launch range marks on ``device`` for the layer ranges of the block,
    which is one training step (eager, or being captured as a CUDA graph):
    its end mark, launched when the block closes, charges the step's
    intervals."""
    global _MARKER
    if _MARKER is not None:
        raise RuntimeError("marking blocks do not nest")
    marker = _Marker(_device(device))
    _MARKER = marker
    try:
        yield
        marker.end()
    finally:
        _MARKER = None
