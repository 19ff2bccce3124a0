"""The benchmark's cell of NAF as published (``chest_50_xor.r1024``) on the
CPU, at a tiny size: its plain reference's hash grid against torch-ngp's
indices worked by hand and against the port's ``hash_grid_indices``; runs
of the cell judged correct; its control and fault judged not; and the
reference module's imports and refusals."""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (
    HashGridSpec,
    hash_encode_fast,
    hash_grid_indices,
)

PORTBENCH = Path(__file__).resolve().parents[1] / "portbench"
sys.path.insert(0, str(PORTBENCH))

import control  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402

CELL = "chest_50_xor.r1024"
MODULE = PORTBENCH / "reference_modules" / "chest_50_xor.py"
CPU = torch.device("cpu")
T = 14        # level 0 dense (17^3 <= 2^14), every other level hashed


def tiny():
    """The cell with its widths as published, cut in table rows, samples,
    rays, detector pixels and views (as ``portbench/tests/conftest.tiny``,
    with 2^14 rows a level)."""
    cell = run.load_cell(CELL)
    cfg = cell.cfg
    cfg["encoder"]["log2_hashmap_size"] = T
    cfg["render"]["n_samples"] = 16
    cfg["scan"]["nDetector"] = [32, 32]
    cfg["scan"]["dDetector"] = [8.0, 8.0]
    cfg["scan"]["numTrain"] = 6
    cell.traffic.update(n_rays=64)
    return cell


@pytest.fixture(scope="module")
def cell():
    return tiny()


def _torch_ngp_row(x, level, corner, enc):
    """torch-ngp's row of ``corner`` (0-7, bit d along axis d) of point ``x``
    (three floats in [0, 1]) at ``level``, in Python ints: uint32 products
    and XOR, then mod 2^T, offset by the level's 2^T rows."""
    scale = np.float32(2.0 ** level * enc["base_resolution"] - 1.0)
    g = [int(np.floor(np.float32(v) * scale + np.float32(0.5))) + (corner >> d & 1)
         for d, v in enumerate(x)]
    res = int(np.ceil(float(scale))) + 1
    size = 1 << int(enc["log2_hashmap_size"])
    if (res + 1) ** 3 <= size:
        idx = g[0] + g[1] * (res + 1) + g[2] * (res + 1) ** 2
    else:
        m = 0xFFFFFFFF
        idx = (g[0] * 1 & m) ^ (g[1] * 19349663 & m) ^ (g[2] * 83492791 & m)
    return level * size + idx % size


@pytest.mark.parametrize("level", [0, 1, 3], ids=["dense", "hashed", "hashed_fine"])
def test_rows_equal_torch_ngp_worked_by_hand(cell, level):
    enc = cell.cfg["encoder"]
    points = [(0.0, 0.0, 0.0), (0.31, 0.77, 0.05), (0.999, 0.5, 0.123), (1.0, 1.0, 1.0)]
    rows = cell.reference.corner_rows(cell.cfg, torch.tensor(points))  # [P, L, 8]
    assert bool(cell.reference.XorHashGrid(enc).dense[level]) == (level == 0)
    for p, pt in enumerate(points):
        for k in range(8):
            assert int(rows[p, level, k]) == _torch_ngp_row(pt, level, k, enc)


def test_rows_equal_the_ports_hash_grid_indices(cell):
    enc = cell.cfg["encoder"]
    spec = HashGridSpec(num_levels=enc["num_levels"], level_dim=enc["level_dim"],
                        base_resolution=enc["base_resolution"], log2_hashmap_size=T)
    x = torch.rand((4096, 3), generator=torch.Generator().manual_seed(3))
    x[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.25, 1.0], [1e-7, 1.0, 0.0]])
    idx, w = hash_grid_indices(spec, x)
    offset = torch.arange(spec.num_levels)[None, :, None] * spec.table_size
    rows, w_ref = cell.reference.XorHashGrid(enc).corners(x)
    assert rows.dtype == torch.int64
    assert torch.equal(rows, idx.long() + offset)
    assert torch.equal(w_ref, w)


def test_the_port_gathers_the_table_in_f32_as_the_reference(cell):
    """The first steps that ``correct`` judges start from a table of ~1e-4,
    where a table gathered in bf16 reads no farther from the reference than
    the program does; on a table of unit scale the port's XOR encoder (the
    training step's, forward and table gradient) is the reference's f32
    encoding, and the bf16 gather is 100x past the tolerance."""
    enc = cell.cfg["encoder"]
    spec = HashGridSpec(num_levels=enc["num_levels"], level_dim=enc["level_dim"],
                        base_resolution=enc["base_resolution"], log2_hashmap_size=T)
    gen = torch.Generator().manual_seed(5)
    x = torch.rand((2048, 3), generator=gen)
    table = torch.randn((spec.num_levels, spec.table_size, spec.level_dim), generator=gen)
    ct = torch.randn((2048, spec.output_dim), generator=gen)
    grid = cell.reference.XorHashGrid(enc)

    def encode(fn):
        t = table.clone().requires_grad_(True)
        out = fn(t)
        (out * ct).sum().backward()
        return out.detach(), t.grad

    out, grad = encode(lambda t: hash_encode_fast(x, t, spec))
    ref_out, ref_grad = encode(lambda t: reference._Encode.apply(x, t, grid))
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grad, ref_grad, atol=1e-5, rtol=1e-5)
    grid.bf16_table = True
    bf16_out, _ = encode(lambda t: reference._Encode.apply(x, t, grid))
    assert float((bf16_out - ref_out).abs().max()) > 1e-3


@pytest.mark.parametrize("seed,trace", [(2 ** 40 + 21, False), (2 ** 33 + 5, False),
                                        (2 ** 40 + 21, True)])
def test_tiny_cell_is_correct(cell, seed, trace, monkeypatch):
    """Untraced on two seeds, traced on one (one traced epoch: the CPU's
    profiler records every op of the plain bucket's passes)."""
    monkeypatch.setattr(run, "TRACE_EPOCHS", 1)
    result, _ = run.run_cell(cell, seed, 0.2, trace, CPU)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_control_and_half_batch_exceed_a_limit(cell):
    prog = run.import_program()
    gaps = control.seed_readings(prog, cell, 2 ** 40 + 21, CPU)
    exceeded = {k: [g for g, v in gaps[k].items() if v > float(cell.limits[g])]
                for k in gaps}
    assert exceeded["program"] == [], gaps
    assert exceeded["control"] and exceeded["half_batch"], gaps


def test_module_imports_neither_jax_nor_the_program():
    tree = ast.parse(MODULE.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names == {"__future__", "typing", "numpy", "torch", "reference"}
    assert not names & {"jax", "jaxlib", "flax", run.PROGRAM,
                        "neuralvolumetricreconstructionformedicalimages_tpu"}


@pytest.mark.parametrize("change", [{"hash_variant": "coherent"},
                                    {"table_dtype": "bfloat16"}, {"pack_sort": True}],
                         ids=["coherent", "bf16_table", "packed"])
def test_module_refuses_what_it_does_not_follow(cell, change):
    cfg = dict(cell.cfg, encoder=dict(cell.cfg["encoder"], **change))
    with pytest.raises(ValueError, match="this reference"):
        cell.reference.corner_rows(cfg, torch.zeros((1, 3)))
    with pytest.raises(ValueError, match="this reference"):
        cell.reference.XorReference(cfg, torch.zeros((6, 32, 32)), {}, steps_per_epoch=6)
