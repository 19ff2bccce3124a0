"""What the harness loads, and how it fails without a card or a program."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import run
from conftest import HERE

ROOT = HERE.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "neuralvolumetricreconstructionformedicalimages_tpu"}


def _loaded(code: str, cwd=ROOT) -> set:
    """The top-level names in ``sys.modules`` after running ``code`` in a
    fresh interpreter with the harness's folder on the path."""
    prog = (f"import sys; sys.path.insert(0, {str(HERE)!r}); {code}; import json; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", prog], cwd=cwd, env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    names = _loaded("import reference, counts")
    assert not names & JAX_NAMES
    assert run.PROGRAM not in names


def test_harness_with_the_program_loads_no_jax():
    names = _loaded("import run, control, trace_reader; run.import_program()")
    assert not names & JAX_NAMES
    assert run.PROGRAM in names


def _first_cell_of_each_configuration():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    first = {}
    for w in bench["workloads"]:
        first.setdefault(w["config"], w["name"])
    return sorted(first.values())


@pytest.mark.parametrize("cell", _first_cell_of_each_configuration())
def test_each_configurations_reference_loads_neither_jax_nor_the_program(cell):
    """The plain reference that each configuration names (``reference.py``
    without the key), loaded as a run loads it."""
    names = _loaded(f"import run; print(run.load_cell({cell!r}).reference.__name__)")
    assert not names & JAX_NAMES
    assert run.PROGRAM not in names


def _run_py(cwd, *extra):
    cmd = [sys.executable, "portbench/run.py", "--workload", "chest_50.r1024",
           "--seed", "1", "--seconds", "1", "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this test is of a machine without one")
    out = _run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_in_a_checkout_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert run.PROGRAM in out.stderr
    with pytest.raises(FileNotFoundError):
        run.import_program(tmp_path)


def test_unknown_workload_fails():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nope",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """One short run of each cell on the card: a result line with every
    key, correct, and both metrics of the cell present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for trace in ("0", "1"):
        cmd = [sys.executable, "portbench/run.py", "--workload", "chest_50.r1024",
               "--seed", "2147483653", "--seconds", "2", "--trace", trace]
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res["checks"]
        assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(res)[-1] == "checks"
        assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
        assert res["metrics"]
