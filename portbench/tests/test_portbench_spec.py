"""BENCHMARK.json and the files it names: well formed, and found by name."""

import json
import re

import pytest

import run
import trace_reader
from conftest import CELLS, HERE

ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CHECKS = {"loss_gap", "grad_gap", "change_gap"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == KEYS
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    # a full check of 24 cells fits the check's 43,200 s
    cells = 24
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("group", sorted(ENTRY_KEYS))
def test_entries_well_formed(bench, group):
    names = [e["name"] for e in bench[group]]
    assert len(names) == len(set(names))
    for e in bench[group]:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[group] <= set(e) <= ENTRY_KEYS[group] | extra
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        for key in ("why", "layer"):
            if key in e:
                assert _line(e[key])
        if group == "configs":
            assert _line(e["source"])


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    for c in configs.values():
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in configs.values()}) == len(configs)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = run.load_cell(name)
    assert set(cell.limits) == CHECKS
    assert all(0 < float(v) < 1 for v in cell.limits.values())
    for key in ("n_rays", "n_batch"):
        assert int(cell.traffic[key]) > 0
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.per_layer:
        reader = trace_reader.load_reader(HERE / "metrics", m["name"])
        assert callable(reader)
    # every key the configuration's reduced names is explained in its file
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}[cell.cfg["exp"]["expname"]]
    assert set(conf["reduced"]) == set(cell.cfg["reduced"])


def test_metric_files_name_known_readers():
    for path in sorted((HERE / "metrics").glob("*.json")):
        desc = json.loads(path.read_text())
        assert desc["reader"] in trace_reader.READERS, path.name
