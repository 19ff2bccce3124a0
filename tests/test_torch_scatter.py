"""Port parity of the encoder microbenchmark and its scatter kernel: the
plain version of ``ops/scatter_level.py`` against the JAX script's Pallas
serial scatter itself (interpret mode, the script's constants shrunk by
``monkeypatch``; no file of the JAX side is touched), and
``scripts/microbench_encoder_torch.py`` end to end on the CPU at a small
shape, against the JAX script's ``fwd_take`` on the same data.

Tolerances: none.  The Pallas loop adds each row's updates one at a time
in update order, as ``np.add.at`` and the CPU's ``index_add_`` do, so the
plain version equals both bit for bit on any payload.  ``scatter_plan``
(the CUDA kernel's launch and workspace sizes) is checked here too; the
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_torch.ops import _build  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import scatter_level as tsl  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_bench(monkeypatch):
    """The JAX microbenchmark as a module, at N = 2^16 updates into
    S = 2^12 rows, its Pallas kernel in interpret mode."""
    from jax.experimental import pallas as pl

    mb = _load("microbench_encoder")
    monkeypatch.setattr(mb, "N", 2 ** 16)
    monkeypatch.setattr(mb, "S", 2 ** 12)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return mb


@pytest.mark.parametrize("payload", ["normal", "integer"])
def test_scatter_level_matches_pallas_serial_scatter(jax_bench, payload):
    rng = np.random.default_rng(20)
    N, S = jax_bench.N, jax_bench.S
    idx = rng.integers(0, S, N).astype(np.int32)
    if payload == "normal":
        pay = rng.normal(size=(N, 2)).astype(np.float32)
    else:
        pay = rng.integers(-50, 50, (N, 2)).astype(np.float32)
    j = np.asarray(jax_bench.pallas_scatter_level(jnp.asarray(idx), jnp.asarray(pay)))
    t = tsl.scatter_level(torch.as_tensor(idx), torch.as_tensor(pay), S)
    assert t.shape == (S, 2) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("C", [1, 2, 4])
def test_scatter_level_plain_sums_rows(C):
    """The plain version against a loop over the updates, including one
    row that takes 700 integer-valued updates (exact in f32)."""
    rng = np.random.default_rng(21)
    S, N = 97, 2000
    idx = rng.integers(0, S, N).astype(np.int32)
    idx[:700] = 13
    pay = rng.integers(-9, 9, (N, C)).astype(np.float32)
    want = np.zeros((S, C), np.float32)
    for i, j in enumerate(idx):
        want[j] += pay[i]
    n0 = _build.LAUNCHES["scatter_level"]
    got = tsl.scatter_level(torch.as_tensor(idx), torch.as_tensor(pay), S)
    assert _build.LAUNCHES["scatter_level"] == n0  # the CPU runs no kernel
    np.testing.assert_array_equal(got.numpy(), want)


def _add_at(idx, pay, S):
    out = np.zeros((S, pay.shape[1]), np.float32)
    np.add.at(out, idx, pay)
    return out


@pytest.mark.parametrize("N", [0, 1, 1027, 1 << 16])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_plain_is_the_in_order_sum(C, N):
    """The plain version is bit-equal to ``np.add.at`` (updates added one
    at a time in stream order) on normal payloads, into a table whose size
    is not a power of two."""
    rng = np.random.default_rng(23 + N + C)
    S = 3001
    idx = rng.integers(0, S, N).astype(np.int32)
    pay = rng.normal(size=(N, C)).astype(np.float32)
    got = tsl.scatter_level_plain(torch.as_tensor(idx), torch.as_tensor(pay), S)
    np.testing.assert_array_equal(got.numpy(), _add_at(idx, pay, S))


@pytest.mark.parametrize("placement", ["leading", "spread"])
def test_plain_is_the_in_order_sum_on_a_hot_row(placement):
    """700 normal-payload updates into one row: a chain of 700 f32 adds
    whose result depends on the order, equal to ``np.add.at``'s."""
    rng = np.random.default_rng(24)
    N, S = 20_000, 997
    idx = rng.integers(0, S, N).astype(np.int32)
    at = np.arange(700) if placement == "leading" else np.sort(rng.permutation(N)[:700])
    idx[at] = 613
    pay = rng.normal(size=(N, 2)).astype(np.float32)
    got = tsl.scatter_level_plain(torch.as_tensor(idx), torch.as_tensor(pay), S).numpy()
    np.testing.assert_array_equal(got, _add_at(idx, pay, S))
    back = np.zeros(2, np.float32)
    for p in pay[at][::-1]:
        back += p
    assert not np.array_equal(got[613], back)   # the order shows in this row


def test_scatter_plan_without_updates():
    plan = tsl.scatter_plan(0, 1 << 19, 2)
    assert plan.n_tiles == 0 and plan.ws_bytes == 0
    assert plan.n_slabs * plan.rows * plan.windows >= 1 << 19


@pytest.mark.parametrize("C", [1, 2, 4])
def test_scatter_plan_table_smaller_than_a_slab(C):
    plan = tsl.scatter_plan(5000, 7, C)
    assert plan.rows * C == tsl.SLAB_FLOATS
    assert (plan.n_slabs, plan.windows, plan.n_tiles) == (1, 1, 2)


@pytest.mark.parametrize("C", [1, 2, 4])
def test_scatter_plan_ragged_last_slab(C):
    """S not a multiple of a slab: the last slab is cut at S, every row is
    in some slab (so every output row is written)."""
    rows = tsl.SLAB_FLOATS // C
    plan = tsl.scatter_plan(1_572_864, 5 * rows + 77, C)
    assert (plan.n_slabs, plan.windows) == (6, 1)
    assert plan.n_tiles == 1_572_864 // tsl.TILE


@pytest.mark.parametrize("N,S,C", [(1_572_864, 1 << 19, 2), (1027, 3001, 4),
                                   (1, 1 << 26, 1), (4097, 1 << 26, 2),
                                   (100, (1 << 27) + 1, 1)])
def test_scatter_plan_workspace_bytes(N, S, C):
    """Each update's staged word (its row within its slab and its place in
    its tile, 16 bits each while a slab has at most 2^16 rows, else 32),
    and the slab offsets of each tile, (n_slabs + 1) * n_tiles int32; at
    most MAX_SLABS slabs, windows doubling beyond that."""
    plan = tsl.scatter_plan(N, S, C)
    n_tiles = -(-N // tsl.TILE)
    assert plan.n_tiles == n_tiles
    assert plan.n_slabs <= tsl.MAX_SLABS
    assert plan.windows & (plan.windows - 1) == 0
    assert plan.n_slabs == -(-S // (plan.rows * plan.windows))
    if plan.windows > 1:
        assert -(-S // (plan.rows * plan.windows // 2)) > tsl.MAX_SLABS
    assert plan.word_bytes == (4 if plan.rows * plan.windows <= 1 << 16 else 8)
    assert plan.ws_bytes == N * plan.word_bytes + (plan.n_slabs + 1) * n_tiles * 4
    if (N, S, C) == (1_572_864, 1 << 19, 2):   # the microbenchmark's shape
        assert (plan.n_slabs, plan.n_tiles, plan.ws_bytes) == (256, 384, 6_686_208)
    if S == (1 << 27) + 1:                     # slabs past 2^16 rows
        assert (plan.windows, plan.word_bytes) == (32, 8)


def test_scatter_level_rejects_other_devices():
    idx = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tsl.scatter_level(idx, torch.zeros((8, 2), device="meta"), 16)


SMALL = dict(B=1024, L=3, S=1 << 12, C=2, K=8)


def test_microbench_runs_on_cpu(capsys):
    mb = _load("microbench_encoder_torch")
    rows = mb.run(device="cpu", iters=1, **SMALL)
    assert set(rows) == set(mb.NAMES)
    for name, r in rows.items():
        assert np.isfinite([r["ms"], r["ns_per_elem"], r["min_ms"],
                            r["checksum"]]).all(), name
        assert r["ms"] > 0 and r["n_elems"] > 0
    out = capsys.readouterr().out
    assert len([ln for ln in out.splitlines() if "ns/elem" in ln]) == len(mb.NAMES)
    with pytest.raises(ValueError, match="unknown"):
        mb.run(["nope"], device="cpu", **SMALL)


def test_microbench_fwd_take_matches_jax(monkeypatch):
    jmb, tmb = _load("microbench_encoder"), _load("microbench_encoder_torch")
    B, L, S, C = 512, 3, 1 << 12, 2
    for k, v in dict(B=B, L=L, S=S, C=C).items():
        monkeypatch.setattr(jmb, k, v)
    rng = np.random.default_rng(22)
    table = (rng.normal(size=(L, S, C)) * 1e-2).astype(np.float32)
    idx = rng.integers(0, S, (B, L, 8)).astype(np.int32)
    w = rng.uniform(size=(B, L, 8)).astype(np.float32)
    j = np.asarray(jmb.fwd_take(*map(jnp.asarray, (table, idx, w))))
    t = tmb.fwd_take(*map(torch.as_tensor, (table, idx, w)))
    assert t.shape == (B, L * C)
    # sums of 8 products of ~1e-2 values, maybe in another order: a few
    # f32 ulps of the terms (~4e-9 each)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-8)
    # the scatter bench computes the plain scatter on the CPU
    pay = rng.normal(size=(B * 8, C)).astype(np.float32)
    np.testing.assert_array_equal(
        tmb.scatter_level(torch.as_tensor(idx[:, 0].reshape(-1)),
                          torch.as_tensor(pay), S).numpy(),
        tsl.scatter_level_plain(torch.as_tensor(idx[:, 0].reshape(-1)),
                                torch.as_tensor(pay), S).numpy())
