"""The per-layer readers of the program's layer ranges
(``layer_ranges.py``, ``metrics/*_ms.py``), on a stub in place of the
program's ``utils/profiling.py``: nothing to read gives None, a stub's
totals the right ms a step."""

import sys
import types
from types import SimpleNamespace

import pytest

import layer_ranges
import trace_reader
from conftest import HERE

# metric -> the ranges it sums
DEVICE = {"batch_sample_ms": ("batch", "sample"),
          "encoder_glue_ms": ("encode.index", "encode.permute", "backward.encode.permute"),
          "mlp_range_ms": ("mlp", "backward.mlp"),
          "render_loss_ms": ("render", "loss", "backward.render"),
          "step_io_ms": ("step.io",)}
METRICS = sorted(DEVICE) + ["host_step_ms"]
RANGES = ("batch", "sample", "encode.index", "encode.sort", "encode.permute",
          "encode.gather", "encode", "mlp", "render", "loss", "backward.render",
          "backward.mlp", "backward.encode.permute", "backward.encode.bucket",
          "backward.encode.unroll", "optim", "step.io")
STEPS = 4


def _stub(monkeypatch, steps):
    """A program module whose ``range_totals`` charges range i (i + 1) ms a
    step over ``steps`` steps."""
    mod = types.ModuleType(layer_ranges.PROFILING)
    mod.range_totals = lambda device=None: {
        "steps": steps,
        "device_ms": {r: (i + 1.0) * steps for i, r in enumerate(RANGES)},
        "hits": {r: steps if r != "encode" else 0 for r in RANGES}}
    monkeypatch.setitem(sys.modules, layer_ranges.PROFILING, mod)


def _ctx(host=(), window_s=1.0):
    return {"trace": SimpleNamespace(steps=STEPS, host=list(host), window_s=window_s),
            "work": {}}


@pytest.mark.parametrize("name", METRICS)
def test_reader_without_a_program_reads_none(monkeypatch, name):
    monkeypatch.setitem(sys.modules, layer_ranges.PROFILING, types.ModuleType("x"))
    assert trace_reader.load_reader(HERE / "metrics", name)(_ctx()) is None


@pytest.mark.parametrize("name", sorted(DEVICE))
def test_reader_without_marked_steps_reads_none(monkeypatch, name):
    _stub(monkeypatch, 0)
    assert trace_reader.load_reader(HERE / "metrics", name)(_ctx()) is None
    _stub(monkeypatch, STEPS - 1)          # not the traced block's steps
    assert trace_reader.load_reader(HERE / "metrics", name)(_ctx()) is None


@pytest.mark.parametrize("name", sorted(DEVICE))
def test_reader_sums_its_ranges(monkeypatch, name):
    _stub(monkeypatch, STEPS)
    want = sum(RANGES.index(r) + 1.0 for r in DEVICE[name])
    got = trace_reader.load_reader(HERE / "metrics", name)(_ctx())
    assert got == pytest.approx(want)


def test_range_with_no_interval_reads_none(monkeypatch):
    _stub(monkeypatch, STEPS)
    assert layer_ranges.range_ms(_ctx(), ("encode",)) is None


def test_host_step_ms():
    read = trace_reader.load_reader(HERE / "metrics", "host_step_ms")
    steps = [("nvr.step", 1000.0 * i, 1000.0 * i + 250.0) for i in range(STEPS)]
    other = [("nvr.epoch", 0.0, 5000.0), ("aten::copy_", 10.0, 20.0)]
    assert read(_ctx(steps + other)) == pytest.approx(0.25)
    assert read(_ctx(other)) is None
    assert read(_ctx(steps[:-1] + other)) is None
    assert read(_ctx(steps + other, window_s=0.0)) is None     # no device ran
