"""Shared set-up of the benchmark's own tests: the harness's modules on the
path, and a cell cut to a size the CPU runs in seconds."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import run  # noqa: E402

CELLS = ("abdomen_50.r1024", "chest_50.r1024", "chest_50.r4096")


def tiny(name: str, root: Path = run.ROOT):
    """Cell ``name`` of ``root/BENCHMARK.json`` with its widths, table width
    and limits as published, cut in table rows, samples, rays, detector
    pixels and views."""
    cell = run.load_cell(name, root)
    cfg = cell.cfg
    cfg["encoder"]["log2_hashmap_size"] = 12
    cfg["render"]["n_samples"] = 16
    cfg["scan"]["nDetector"] = [32, 32]
    cfg["scan"]["dDetector"] = [8.0, 8.0]
    cfg["scan"]["numTrain"] = 6
    cell.traffic.update(n_rays=64)
    return cell


@pytest.fixture
def prog():
    return run.import_program()
