"""The plain reference against the program's CPU path at a tiny size, the
comparison's control and faults, the counts and the trace reader."""

import json
import math
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import control
import counts
import reference
import run
import trace_reader
from conftest import CELLS, tiny

CPU = torch.device("cpu")


def _limits_exceeded(gaps, limits):
    return [k for k, v in gaps.items() if v > float(limits[k])]


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct_against_the_reference(name):
    result, phases = run.run_cell(tiny(name), 2 ** 33 + 5, 0.2, False, CPU)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"rays_per_s", "step_ms_p95", "peak_mem_mb", "setup_s"}
    assert set(phases) == {"setup_s", "window_s", "reference_s"}


def test_traced_run_reports_per_layer_metrics_it_finds():
    result, _ = run.run_cell(tiny("chest_50.r1024"), 7, 0.2, True, CPU)
    assert result["correct"], result["checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU runs no kernel: no device metric is read, none reads 0
    assert result["metrics"] == {}


def test_a_reader_that_loads_jax_stops_the_result(tmp_path, monkeypatch, capsys):
    """A per-layer reader that imports a module named ``jax`` (a stub here)
    leaves it in ``sys.modules``: the run ends with code 3 and no result."""
    assert "jax" not in sys.modules
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    metrics = tmp_path / "metrics"
    shutil.copytree(run.HERE / "metrics", metrics)
    (metrics / "x.py").write_text("import jax  # noqa: F401\n\n\ndef read(ctx):\n    return None\n")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    cell = tiny("chest_50.r1024")
    cell.metrics_dir = metrics
    cell.per_layer.append({"name": "x", "unit": "ms"})
    try:
        result, phases = run.run_cell(cell, 5, 0.2, True, CPU)
        capsys.readouterr()
        assert run.finish(result, phases) == 3
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert out.out.strip() == ""
    assert "jax" in out.err


def test_a_clean_run_prints_its_result_last(capsys):
    result, phases = run.run_cell(tiny("chest_50.r1024"), 6, 0.2, False, CPU)
    assert run.finish(result, phases) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    assert out.err.strip().splitlines()[-1].startswith("check change_gap")


def _ticks_twice(timer):
    return SimpleNamespace(tick=lambda: (timer.tick(), timer.tick()))


def _no_ticks(timer):
    return None


@pytest.mark.parametrize("mark", [_ticks_twice, _no_ticks])
def test_step_marks_that_do_not_match_the_steps_fail_the_run(monkeypatch, mark):
    """The steps are the harness's count; a program that marks a step
    boundary twice, or not at all, fails the run rather than changing the
    rate or the tail."""
    epoch = run.Program.epoch

    def marked(self, order, start, draws, lo, hi, timer=None):
        return epoch(self, order, start, draws, lo, hi,
                     None if timer is None else mark(timer))

    monkeypatch.setattr(run.Program, "epoch", marked)
    with pytest.raises(run.MeasurementError):
        run.run_cell(tiny("chest_50.r1024"), 8, 0.2, False, CPU)


def _no_update(prog, monkeypatch):
    make = prog.optim.make_optimizer

    def frozen(cfg, params):
        opt = make(cfg, params)
        opt.step = lambda *a, **k: None
        return opt

    monkeypatch.setattr(prog.optim, "make_optimizer", frozen)


def _half_batch(prog, monkeypatch):
    get = prog.trainer.get_loss_fn

    def halved(name="mse", group=None):
        fn = get(name, group)

        def loss(pred, target, mask=None, aux=None):
            n = pred.shape[0] // 2
            return fn(pred[:n], target[:n], None if mask is None else mask[:n], aux)

        return loss

    monkeypatch.setattr(prog.trainer, "get_loss_fn", halved)


@pytest.mark.parametrize("fault", [_no_update, _half_batch])
@pytest.mark.parametrize("name", CELLS)
def test_broken_step_is_not_correct(prog, monkeypatch, fault, name):
    """The whole run with the timed path broken underneath: a step that
    leaves its state unchanged, or that leaves half of the batch out."""
    fault(prog, monkeypatch)
    result, _ = run.run_cell(tiny(name), 3, 0.2, False, CPU)
    assert not result["correct"]
    assert _limits_exceeded({k: c["value"] for k, c in result["checks"].items()},
                            tiny(name).limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_in_tf32_fails_and_program_passes(prog, name):
    """The control (the reference in TF32) and the half-batch fault each
    fail a limit of the cell; the program passes all of them."""
    cell = tiny(name)
    for seed in (11, 12, 13):
        gaps = control.seed_readings(prog, cell, seed, CPU)
        assert not _limits_exceeded(gaps["program"], cell.limits), gaps
        assert _limits_exceeded(gaps["control"], cell.limits), gaps
        assert _limits_exceeded(gaps["half_batch"], cell.limits), gaps


def test_reference_encoder_matches_the_program(prog):
    """The reference's hash-grid features equal the program's sorted
    encoder's, bit for bit, on the CPU."""
    from neuralvolumetricreconstructionformedicalimages_torch.models import get_encoder

    cfg = tiny("chest_50.r1024").cfg
    enc = dict(cfg["encoder"])
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((500, 3), generator=gen) * 0.6 - 0.3
    table = torch.rand((16, 1 << 12, 2), generator=gen) * 2e-4 - 1e-4
    x01 = torch.clamp((x + 0.3) / (2.0 * 0.3), 0.0, 1.0)
    ours = reference._Encode.apply(x01, table, reference.HashGrid(enc))
    theirs = get_encoder(**enc).apply({"table": table}, x, 0.3)
    assert torch.equal(ours, theirs)


def test_tf32_rounding():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -11 + 2 ** -20, -2.5])
    assert reference._tf32(x).tolist() == [1.0, 1 + 2 ** -9, 1 + 2 ** -10, -2.5]


def test_sphere_projection_is_its_chord():
    """A unit-density sphere of radius 10 mm at the centre: the central
    pixel reads its diameter, a pixel outside its shadow reads 0."""
    cfg = tiny("chest_50.r1024").cfg
    cfg["phantom"] = {"density_jitter": 0.0, "ellipsoids": [[0, 0, 0, 0.01, 0.01, 0.01, 1.0]]}
    cfg["scan"]["nDetector"] = [33, 33]
    _, proj = reference.make_scan(cfg, 0, CPU)
    assert proj.shape == (6, 33, 33)
    assert torch.allclose(proj[:, 16, 16], torch.full((6,), 0.02), rtol=1e-5)
    assert float(proj[:, 0, 0].abs().max()) == 0.0


def test_counts_of_a_hand_worked_shape():
    dims = [(4, 3), (3, 1)]
    assert counts.mlp_flop_per_point(dims) == 3 * (2 * 4 * 3 + 2 * 3 * 1)
    assert counts.encoder_flop_per_point_level(2) == (8 * 2 + 3 + 2 * 8 * 2) + 2 * 8 * 2
    assert counts.step_flop(10, dims, 2, 2, 100) == 10 * 90 + 10 * 2 * 83 + 100 * 13
    work = counts.hash_encoder_work(points=10, levels=2, table_rows=8, channels=2,
                                    distinct_rows=5)
    assert work == {"bytes": 8 * 20 + 8 * 5 + 8 * 20 + 8 * 20 + 8 * 16, "flop": 20 * 83}
    assert counts.least_seconds(work) == max(648 / 3.35e12, 1660 / 67e12)
    rows = torch.tensor([[[0, 1, 1, 2]], [[2, 7, 7, 0]]])
    assert counts.distinct_rows(rows) == 4


def _event(name, dev, start, end):
    kind = torch.autograd.DeviceType.CUDA if dev else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind, is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end))


def test_trace_reader_of_a_hand_made_trace():
    """Two steps: kernels a (0-40 us), b (30-60) and a (100-150) on the
    device, and the host launching at 60-100 us."""
    events = [_event("a", True, 0.0, 40.0), _event("b", True, 30.0, 60.0),
              _event("a", True, 100.0, 150.0), _event("cudaGraphLaunch", False, 55.0, 105.0),
              _event("portbench.epoch", True, 0.0, 150.0)]
    tr = trace_reader.Trace(SimpleNamespace(events=lambda: events), steps=2)
    assert math.isclose(tr.window_s, 150e-6) and math.isclose(tr.busy_s, 110e-6)
    ctx = {"trace": tr, "work": {"train_step": 67e12 * 75e-6 * 0.5,
                                 "hash_encoder": {"bytes": 3.35e12 * 45e-6, "flop": 0.0}}}
    assert math.isclose(trace_reader._idle_share(ctx), 100 * 40 / 150)
    assert math.isclose(trace_reader._kernel_ms(ctx, kernels=["a"]), 0.045)
    assert trace_reader._kernel_ms(ctx, kernels=["z"]) is None
    assert math.isclose(trace_reader._mfu(ctx, work="train_step"), 50.0)
    assert math.isclose(trace_reader._roofline(ctx, kernels=["a"], work="hash_encoder"), 100.0)
    assert trace_reader._roofline(ctx, kernels=["z"], work="hash_encoder") is None
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "a" and math.isclose(bd["device_ops"][0][1], 90e-6)
    assert bd["idle_gaps"][0][0] == "cudaGraphLaunch"
    assert math.isclose(bd["idle_gaps"][0][1], 40e-6)


def test_compare_reads_each_gap():
    ref = {"loss": [2.0, 1.0], "grad": {"a": 1.0, "b": 4.0, "c": 1e-9},
           "change": {"a": 2.0, "b": 2.0, "c": 5.0}}
    prog = {"loss": [2.0, 1.1], "grad": {"a": 1.0, "b": 3.0, "c": 0.0},
            "change": {"a": 2.0, "b": 2.2, "c": 0.0}}
    gaps = reference.compare(prog, ref)
    assert math.isclose(gaps["loss_gap"], 0.1)
    assert math.isclose(gaps["grad_gap"], 0.25)
    # leaf c's gradient is nought to rounding: its change is left out
    assert math.isclose(gaps["change_gap"], 0.1)
    prog["loss"][0] = float("nan")
    assert reference.compare(prog, ref)["loss_gap"] == float("inf")


def test_draws_refilled_in_place_equal_fresh_ones():
    counts_ = torch.tensor([5, 9, 3])
    views = torch.tensor([[0], [2], [1]])
    fresh = reference.draw_epoch(torch.Generator().manual_seed(1), counts_, views, 8, 4)
    buf = reference.draw_epoch(torch.Generator().manual_seed(2), counts_, views, 8, 4)
    again = reference.draw_epoch(torch.Generator().manual_seed(1), counts_, views, 8, 4, out=buf)
    assert again is buf
    for k in ("r", "t_rand"):
        assert torch.equal(fresh[k], again[k])
    assert bool((fresh["r"] < counts_[views][:, :, None]).all())
    assert np.array_equal(fresh["r"].shape, (3, 1, 8))
