"""The port's ``Trainer`` on a mesh, on the CPU under gloo: a mesh of one
(``parallel.force_mesh``, a one-rank group the trainer makes itself) bit-equal
to the plain trainer; two ranks (data=2, ``tests/_parallel_ranks.py``)
with replicated parameters, rank 0 alone writing, and a resume; the
refusals of a mesh without its processes; ``initialize_multihost``; and the
eval PNG written without ``imageio``.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _parallel_ranks as R
from neuralvolumetricreconstructionformedicalimages_torch.parallel import mesh as tmesh
from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as ttrainer
from neuralvolumetricreconstructionformedicalimages_torch.utils.logging import (
    ExperimentLogger)


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The trainer logs JSONL only here (TensorBoard's import is slow)."""
    monkeypatch.setattr(ttrainer, "ExperimentLogger",
                        functools.partial(ExperimentLogger, enable_tensorboard=False))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One run of ``_parallel_ranks.job_trainer`` on 2 gloo ranks."""
    tmp = tmp_path_factory.mktemp("trainer2")
    workdir = str(tmp / "run")
    out = R.spawn(2, "trainer", {"workdir": workdir}, str(tmp / "spawn"))
    return workdir, [o["job_trainer"] for o in out]


def _check_force_mesh(tmp_path, monkeypatch, n_batch):
    monkeypatch.setattr(tmesh, "DEFAULT_TIMEOUT_S", R.GROUP_TIMEOUT_S)
    assert not dist.is_initialized()
    runs = R.force_mesh_runs(tmp_path, "cpu", n_batch)
    assert not dist.is_initialized()
    assert runs["mesh"][0].shape == (6,)
    assert torch.equal(runs["mesh"][0], runs["plain"][0])
    for a, b in zip(runs["mesh"][1].parameters(), runs["plain"][1].parameters()):
        assert torch.equal(a, b)


def test_force_mesh_matches_plain_trainer(tmp_path, no_tensorboard, monkeypatch):
    """A mesh of one through the sharded step, on a one-rank gloo group the
    trainer makes and closes: the same losses and parameters, bit for bit,
    as the plain trainer over 6 steps."""
    _check_force_mesh(tmp_path, monkeypatch, 1)


def test_force_mesh_matches_plain_trainer_two_views(tmp_path, no_tensorboard,
                                                    monkeypatch):
    """As above at two views a step: both steps gather their batch with
    ``gather_batch``, so a mesh of one draws what the plain trainer draws."""
    _check_force_mesh(tmp_path, monkeypatch, 2)


def test_mesh_without_its_processes_raises(tmp_path):
    """A mesh larger than one never trains as one process: without a group
    the trainer names the launch; with a group of the wrong size
    ``make_mesh`` refuses (``tests/test_torch_parallel.py``)."""
    cfg = R.smoke_cfg(str(tmp_path), mesh={"data": 2})
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        ttrainer.Trainer(cfg, workdir=str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="needs a process group"):
        tmesh.make_mesh(tmesh.MeshSpec(data=2), "cpu")
    assert not dist.is_initialized()


def test_initialize_multihost_single_process(monkeypatch):
    """With no coordinator and no torchrun environment it is a single
    process and makes no group; a coordinator needs its ranks; the card's
    group needs a card."""
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    tmesh.initialize_multihost(backend="gloo")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="num_processes and process_id"):
        tmesh.initialize_multihost("localhost:1", backend="gloo")
    # the card by default, and no quiet move to the CPU without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.initialize_multihost("localhost:1", 1, 0)
    assert not dist.is_initialized()


def test_two_ranks_keep_equal_params(two_ranks):
    """After two epochs of data-parallel steps, and after the resumed
    third, both ranks hold the same parameters, bit for bit, and read the
    same (global) losses."""
    _, (r0, r1) = two_ranks
    for run in ("first", "resumed"):
        assert r0[run]["params"].keys() == r1[run]["params"].keys()
        for k in r0[run]["params"]:
            assert np.array_equal(r0[run]["params"][k], r1[run]["params"][k]), (run, k)
        assert r0[run]["losses"] == r1[run]["losses"]


def test_two_ranks_loss_falls(two_ranks):
    _, (r0, _) = two_ranks
    losses = np.asarray(r0["first"]["losses"])
    assert losses.shape == (40,) and np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()
    assert r0["first"]["global_step"] == 40


def test_only_rank0_writes(two_ranks):
    """Rank 0 evaluates, logs and checkpoints; rank 1 writes no file."""
    workdir, (r0, r1) = two_ranks
    assert r0["first"]["evals"] == [0, 1] and r1["first"]["evals"] == []
    assert r0["first"]["logger"] and not r1["first"]["logger"]
    assert r1["resumed"]["writes"] == []
    assert {"save", "_save_png"} <= set(r0["first"]["writes"])
    assert sorted(os.listdir(os.path.join(workdir, "ckpt"))) == [
        "ckpt_000001.pt", "ckpt_000002.pt"]
    assert sorted(os.listdir(os.path.join(workdir, "eval"))) == [
        "epoch_00000", "epoch_00001"]


def test_two_ranks_resume_the_same_step(two_ranks):
    """Both ranks restore the epoch-1 checkpoint: the same step, the
    parameters they trained, and one more epoch of 20 steps."""
    _, ranks = two_ranks
    for r in ranks:
        res = r["resumed"]
        assert res["epoch_start"] == 2 and res["global_step"] == 40
        assert res["same_params"]
        assert len(res["losses"]) == 20 and np.isfinite(res["losses"]).all()


# ------------------------------------------------------------ eval PNGs

def _image():
    rng = np.random.default_rng(5)
    img = rng.uniform(-0.2, 1.2, size=(37, 53, 3)).astype(np.float32)
    return img, (np.clip(img[..., 0], 0, 1) * 255).astype(np.uint8)


def test_png_reads_back_pixel_equal(tmp_path):
    """The standard-library PNG holds the bytes the JAX package hands to
    ``imageio`` (``clip * 255`` as uint8), as ``imageio`` reads them."""
    iio = pytest.importorskip("imageio.v2")
    img, want = _image()
    path = str(tmp_path / "x.png")
    ttrainer._save_png(path, img)
    got = np.asarray(iio.imread(path))
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_png_written_without_imageio(tmp_path, monkeypatch):
    """Without ``imageio`` the PNG is still written, with the same bytes."""
    img, _ = _image()
    ttrainer._save_png(str(tmp_path / "a.png"), img)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError):
        import imageio.v2  # noqa: F401
    ttrainer._save_png(str(tmp_path / "b.png"), img)
    data = (tmp_path / "b.png").read_bytes()
    assert data.startswith(b"\x89PNG\r\n\x1a\n")
    assert data == (tmp_path / "a.png").read_bytes()
