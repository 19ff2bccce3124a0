"""A configuration's own plain reference: resolved by ``run.load_cell``,
used by the run and by ``control.py``, refused outside the harness's
folder."""

import json
import shutil
import sys
from types import SimpleNamespace

import pytest
import torch

import control
import reference
import run
from conftest import CELLS, HERE, tiny

CPU = torch.device("cpu")
PROBE = "tests/probe_half_batch_reference.py"


def _exceeded(gaps, limits):
    return [k for k, v in gaps.items() if v > float(limits[k])]


def _root_naming(tmp_path, rel, config="chest_50"):
    """A checkout root in ``tmp_path`` whose ``BENCHMARK.json`` is the
    repository's and whose file of ``config`` is a copy with ``reference:
    rel``."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    file = {c["name"]: c["file"] for c in bench["configs"]}[config]
    cfg = json.loads((run.ROOT / file).read_text())
    cfg["reference"] = rel
    (tmp_path / file).parent.mkdir(parents=True, exist_ok=True)
    (tmp_path / file).write_text(json.dumps(cfg))
    return tmp_path


@pytest.mark.parametrize("name", CELLS)
def test_shipped_configurations_resolve_to_reference_py(name):
    assert run.load_cell(name).reference is reference


def test_a_run_reads_what_reference_py_reads_on_the_same_inputs():
    """A tiny run's reference readings, and the inputs it hands the
    reference, equal those of a direct ``reference.reference_readings``
    call on inputs made anew from the seed."""
    seed = 2 ** 40 + 21
    cell = tiny("chest_50.r1024")
    calls = []

    def recorded(*args, **kw):
        out = reference.reference_readings(*args, **kw)
        calls.append((args, out))
        return out

    cell.reference = SimpleNamespace(**{n: getattr(reference, n) for n in run.REFERENCE_API})
    cell.reference.reference_readings = recorded
    result, _ = run.run_cell(cell, seed, 0.2, False, CPU)
    assert result["correct"], result["checks"]
    (cfg, proj, weights, draws, views), readings = calls[0]

    n_rays, n_samples = int(cell.traffic["n_rays"]), int(cell.cfg["render"]["n_samples"])
    _, proj0 = reference.make_scan(cell.cfg, seed, CPU)
    weights0 = reference.make_weights(cell.cfg, seed, CPU)
    spe = proj0.shape[0] // int(cell.traffic["n_batch"])
    views0 = torch.arange(proj0.shape[0]).reshape(spe, -1)
    pool = (proj0.reshape(proj0.shape[0], -1) != 0).sum(1)
    draws0 = reference.draw_epoch(reference.generator(seed, reference.DRAWS, CPU), pool,
                                  views0, n_rays, n_samples)
    assert torch.equal(proj, proj0) and torch.equal(views, views0)
    assert weights.keys() == weights0.keys()
    assert all(torch.equal(weights[k], weights0[k]) for k in weights0)
    assert all(torch.equal(draws[k], draws0[k]) for k in ("r", "t_rand"))
    direct = reference.reference_readings(cfg, proj0, weights0, draws0, views0,
                                          steps=run.CHECK_STEPS, steps_per_epoch=spe)
    assert readings == direct


def test_a_probe_reference_judges_the_run_and_the_control(tmp_path, prog):
    """A copy of ``chest_50`` naming a probe whose readings leave half of
    the batch out: the run and ``control.seed_readings`` are judged by it,
    so the sound program fails its limits."""
    root = _root_naming(tmp_path, PROBE)
    cell = tiny("chest_50.r1024", root)
    assert cell.reference is not reference
    assert cell.reference.__name__ in sys.modules
    assert cell.reference.__file__ == str((HERE / PROBE).resolve())
    assert run.load_cell("chest_50.r1024", root).reference is cell.reference
    result, _ = run.run_cell(cell, 4, 0.2, False, CPU)
    assert not result["correct"]
    assert _exceeded({k: c["value"] for k, c in result["checks"].items()}, cell.limits)
    gaps = control.seed_readings(prog, cell, 4, CPU)
    assert _exceeded(gaps["program"], cell.limits), gaps


@pytest.mark.parametrize("rel", ["../BENCHMARK.json", "tests/../reference.py",
                                 str(HERE / "reference.py"), ""])
def test_a_path_that_is_not_inside_the_harness_is_refused(tmp_path, rel):
    root = _root_naming(tmp_path, rel)
    with pytest.raises(ValueError, match="chest_50.*'reference'"):
        run.load_cell("chest_50.r1024", root)


def _harness_copy(tmp_path, monkeypatch):
    """A copy of the harness's folder, which ``run`` then takes for its
    own."""
    here = (tmp_path / "portbench").resolve()
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(run, "HERE", here)
    return here


def test_a_link_out_of_the_harness_is_refused(tmp_path, monkeypatch):
    here = _harness_copy(tmp_path, monkeypatch)
    (tmp_path / "outside.py").write_text((HERE / PROBE).read_text())
    (here / "out.py").symlink_to(tmp_path / "outside.py")
    root = _root_naming(tmp_path, "out.py")
    with pytest.raises(ValueError, match="chest_50.*outside"):
        run.load_cell("chest_50.r1024", root)


def test_a_missing_file_is_refused(tmp_path):
    root = _root_naming(tmp_path, "references/none.py")
    with pytest.raises(FileNotFoundError, match="chest_50.*'reference'"):
        run.load_cell("chest_50.r1024", root)


@pytest.mark.parametrize("lacking", run.REFERENCE_API)
def test_a_module_without_one_of_the_five_names_is_refused(tmp_path, monkeypatch, lacking):
    here = _harness_copy(tmp_path, monkeypatch)
    rel = f"references/lacks_{lacking}.py"
    (here / rel).parent.mkdir()
    names = ", ".join(n for n in run.REFERENCE_API if n != lacking)
    (here / rel).write_text(f"from reference import {names}  # noqa: F401\n")
    root = _root_naming(tmp_path, rel)
    with pytest.raises(ImportError, match=f"chest_50.*'reference'.*lacks {lacking}"):
        run.load_cell("chest_50.r1024", root)


def test_a_module_that_fails_to_load_is_refused(tmp_path, monkeypatch):
    here = _harness_copy(tmp_path, monkeypatch)
    (here / "broken.py").write_text("raise RuntimeError('no')\n")
    root = _root_naming(tmp_path, "broken.py")
    with pytest.raises(ImportError, match="chest_50.*'reference'.*RuntimeError"):
        run.load_cell("chest_50.r1024", root)
