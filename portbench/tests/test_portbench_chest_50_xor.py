"""The cell of NAF as published, ``chest_50_xor.r1024``: its configuration,
its own plain reference, its entries in BENCHMARK.json, and a run of it on
the card."""

import json
import subprocess
import sys

import pytest
import torch

import reference
import run
import trace_reader
from conftest import HERE

ROOT = HERE.parent
CELL = "chest_50_xor.r1024"
METRICS = ("xor_encode_ms", "xor_backward_ms", "xor_encoder_roofline")
NAF_HASH = "naf_cbct/blob/main/src/encoder/hashencoder/src/hashencoder.cu"


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_cell_is_judged_by_its_own_reference():
    cell = run.load_cell(CELL)
    assert cell.reference is not reference
    module = HERE / "reference_modules" / "chest_50_xor.py"
    assert cell.reference.__file__ == str(module.resolve())
    assert all(callable(getattr(cell.reference, n)) for n in run.REFERENCE_API)


def test_the_configuration_is_chest_50_with_the_xor_hash():
    """``chest_50_xor`` is ``chest_50`` with NAF's hash, its table gathered
    in f32 and its positions unpacked; every width, the scan, the phantom
    and the training are chest_50's. Its source is NAF's hash grid, and
    its settings name chest_50's source."""
    xor = json.loads((HERE / "configs" / "chest_50_xor.json").read_text())
    base = json.loads((HERE / "configs" / "chest_50.json").read_text())
    assert xor["reference"] == "reference_modules/chest_50_xor.py"
    assert xor["exp"] == {"expname": "chest_50_xor"}
    assert xor["encoder"] == {**{k: v for k, v in base["encoder"].items() if k != "forward"},
                              "hash_variant": "xor", "table_dtype": "float32",
                              "pack_sort": False}
    for key in ("network", "render", "train", "log", "scan", "phantom", "reduced"):
        assert xor[key] == base[key], key
    assert xor["source"].endswith(NAF_HASH)
    assert xor["settings_from"].startswith(base["source"] + ":")


def test_the_new_entries(bench):
    conf = {c["name"]: c for c in bench["configs"]}["chest_50_xor"]
    assert conf["file"] == "portbench/configs/chest_50_xor.json"
    assert conf["reduced"] == ["exp.datadir"]
    assert conf["source"].endswith(NAF_HASH)
    assert all((c["source"], c["reduced"]) != (conf["source"], conf["reduced"])
               for c in bench["configs"] if c is not conf)
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("chest_50_xor", "r1024", 1)
    assert len(cell["why"]) <= 200
    mine = [m for m in bench["per_layer"] if CELL in m.get("workloads", [])]
    assert [m["name"] for m in mine] == list(METRICS)
    for m in mine:
        assert m["workloads"] == [CELL] and m["source"] == "device_trace"
        assert m["layer"] == "encoder, XOR path" and m["moves"] == "rays_per_s"


def test_the_cells_files_and_readers(bench):
    cell = run.load_cell(CELL)
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    assert {m["name"] for m in cell.end_to_end} == {m["name"] for m in bench["end_to_end"]}
    for name in METRICS:
        assert callable(trace_reader.load_reader(HERE / "metrics", name))


class _Trace:
    steps = 4


def test_readers_read_the_four_ranges_and_nothing_without_them(monkeypatch):
    """On range totals of 4 steps, the readers sum their ranges a step and
    divide the encoder's least time by the four; without one of the four
    ranges (a program that does not mark them) the roofline is None."""
    import layer_ranges

    ms = {"encode.index": 4.0, "encode.gather": 8.0, "backward.encode.sort": 12.0,
          "backward.encode.bucket": 16.0}
    totals = {"steps": 4, "device_ms": dict(ms), "hits": {k: 4 for k in ms}}
    monkeypatch.setattr(layer_ranges, "totals", lambda ctx: totals)
    work = {"bytes": 3.35e9, "flop": 0.0}          # 1 ms at the HBM peak
    ctx = {"trace": _Trace(), "work": {"hash_encoder": work}}
    read = {n: trace_reader.load_reader(HERE / "metrics", n) for n in METRICS}
    assert read["xor_encode_ms"](ctx) == pytest.approx(3.0)
    assert read["xor_backward_ms"](ctx) == pytest.approx(7.0)
    assert read["xor_encoder_roofline"](ctx) == pytest.approx(10.0)
    totals["hits"]["backward.encode.sort"] = 0
    assert read["xor_encoder_roofline"](ctx) is None


@pytest.mark.cuda
def test_a_run_of_the_cell_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable, "portbench/run.py", "--workload", CELL, "--seed", "2147483659",
           "--seconds", "2", "--trace", "1"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(METRICS)
