"""The port's timing utilities on the CPU: ``time_fn`` (host clock for
CPU results; CUDA events only when a result lies on the card) and
``profiler_trace`` (``torch.profiler``, a Chrome trace file)."""

import json
import time

import pytest
import torch

from neuralvolumetricreconstructionformedicalimages_torch.utils import profiling


def test_time_fn_on_cpu():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        time.sleep(0.002)
        return x * scale

    r = profiling.time_fn(fn, torch.ones(4), warmup=3, iters=5, scale=2.0)
    assert len(calls) == 1 + 2 + 5      # first call, warm-up, timed calls
    assert set(r) == {"compile_s", "mean_s", "median_s", "min_s", "std_s", "iters"}
    assert r["iters"] == 5
    assert 0.002 <= r["min_s"] <= r["median_s"] <= 1.0
    assert r["min_s"] <= r["mean_s"] and r["std_s"] >= 0.0 and r["compile_s"] > 0


def test_time_fn_detects_the_card_from_results():
    assert not profiling._on_cuda((torch.ones(2), {"a": [torch.zeros(1)]}, 3))
    assert not profiling._on_cuda(None)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profiler_trace(str(tmp_path / "prof")) as prof:
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    assert prof is not None
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names
    with open(tmp_path / "prof" / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)


def test_profiler_trace_off_is_a_no_op():
    with profiling.profiler_trace(None) as prof:
        pass
    assert prof is None


@pytest.mark.cuda
def test_time_fn_uses_cuda_events_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones((1024, 1024), device="cuda")
    r = profiling.time_fn(torch.mm, x, x, warmup=2, iters=5)
    assert 0 < r["min_s"] <= r["median_s"] < 1.0
