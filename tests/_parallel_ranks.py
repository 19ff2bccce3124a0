"""Rank-side code of the parallel tests: ``spawn(world, ...)`` starts
``world`` processes under gloo (a ``FileStore``, no TCP port), each runs
the jobs named for it and pickles its results.  Imports torch, numpy and
the port, never JAX: every rank imports this module."""

from __future__ import annotations

import datetime
import functools
import os
import os.path as osp
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from neuralvolumetricreconstructionformedicalimages_torch.config import (
    load_config, with_defaults)
from neuralvolumetricreconstructionformedicalimages_torch.losses import get_loss_fn
from neuralvolumetricreconstructionformedicalimages_torch.models import params_from_jax
from neuralvolumetricreconstructionformedicalimages_torch.parallel import step as pstep
from neuralvolumetricreconstructionformedicalimages_torch.parallel.mesh import (
    MeshSpec, local_batch_size, make_mesh)
from neuralvolumetricreconstructionformedicalimages_torch.train import optim as toptim
from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as ttrainer
from neuralvolumetricreconstructionformedicalimages_torch.utils.logging import (
    ExperimentLogger)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
GROUP_TIMEOUT_S = 60      # every collective of a rank fails after this
JOIN_TIMEOUT_S = 240      # a spawn that has not ended by then fails its test
LOSS_NAMES = ("mse", "huber+small", "l1+zero", "phase")
# the sharded-step layouts (data, sample) of each world size
STEP_LAYOUTS = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
N_RAYS, N_SAMPLES = 128, 16


def tiny_cfg(n_rays: int = N_RAYS, n_samples: int = N_SAMPLES, perturb: bool = True):
    """The tiny model of ``tests/test_parallel.py`` (a 2^8 table: the plain
    hash paths of both packages), as a plain dict for either package's
    ``with_defaults``."""
    return {
        "exp": {"expname": "t", "expdir": "/tmp", "datadir": ""},
        "network": {"net_type": "mlp", "num_layers": 3, "hidden_dim": 16,
                    "skips": [1], "out_dim": 1, "last_activation": "sigmoid",
                    "bound": 0.3},
        "encoder": {"encoding": "hashgrid", "input_dim": 3, "num_levels": 4,
                    "level_dim": 2, "base_resolution": 4,
                    "log2_hashmap_size": 8},
        "render": {"n_samples": n_samples, "n_fine": 0, "perturb": perturb,
                   "raw_noise_std": 0.0, "netchunk": 4096},
        "train": {"epoch": 2, "n_batch": 1, "n_rays": n_rays, "lrate": 1e-3,
                  "lrate_gamma": 0.1, "lrate_step": 100, "resume": False},
        "log": {"i_eval": 0, "i_save": 0},
    }


def loss_arrays():
    """pred, target, mask [64, 16] with a non-uniform mask."""
    rng = np.random.default_rng(11)
    pred = rng.normal(size=(64, 16)).astype(np.float32)
    target = rng.normal(size=(64, 16)).astype(np.float32)
    mask = (rng.random((64, 16)) > 0.4).astype(np.float32)
    return pred, target, mask


def smoke_cfg(workdir: str, **parallel):
    """``configs/smoke.yaml`` cut for the CPU: 128 rays x 32 samples, two
    epochs (0 and 1) with evals and a checkpoint at epoch 1."""
    cfg = load_config(osp.join(REPO, "configs", "smoke.yaml"))
    cfg["exp"]["datadir"] = osp.join(REPO, "data", "smoke.pickle")
    cfg["train"].update(epoch=1, n_rays=128)
    cfg["render"]["n_samples"] = 32
    cfg["log"].update(i_eval=1, i_save=1)
    cfg["parallel"] = dict(parallel)
    return cfg


def force_mesh_runs(tmp_path, device, n_batch: int = 1, steps: int = 6):
    """:func:`smoke_cfg` at ``n_batch`` views a step, trained ``steps``
    eager ``train_step`` steps by the plain trainer and by a mesh of one
    (``parallel.force_mesh``: the sharded step on a one-rank group the
    trainer makes and closes): ``{"plain"|"mesh": (losses, field)}``."""
    runs = {}
    for name, par in (("plain", {}),
                      ("mesh", {"mesh": {"data": 1, "sample": 1}, "force_mesh": True})):
        cfg = smoke_cfg(osp.join(str(tmp_path), name), **par)
        cfg["train"]["n_batch"] = n_batch
        cfg["log"].update(i_eval=0, i_save=0)
        tr = ttrainer.Trainer(cfg, workdir=osp.join(str(tmp_path), name), device=device)
        try:
            assert (tr.mesh is not None) == (name == "mesh")
            assert dist.is_initialized() == (name == "mesh")
            runs[name] = (torch.stack([tr.train_step(v)
                                       for v in tr._view_order(0)[:steps]]), tr.field)
        finally:
            tr.close()
    return runs


def tiny_field(params):
    field = ttrainer.build_model(with_defaults(tiny_cfg()))
    field.load_state_dict(params_from_jax(params))
    return field


def flat_grads(module) -> np.ndarray:
    return torch.cat([p.grad.reshape(-1) for p in module.parameters()]).numpy()


def outcome(fn):
    """``("ok", value)`` or the exception's type name and message."""
    try:
        return ("ok", fn())
    except Exception as exc:  # the raises are what some jobs record
        return (type(exc).__name__, str(exc))


# ---------------------------------------------------------------- jobs

def job_losses(inputs, rank, world):
    """Each loss over the data group, this rank's rows of the batch: the
    value and the gradient w.r.t. this rank's ``pred`` rows."""
    mesh = make_mesh(MeshSpec(world, 1), "cpu")
    pred, target, mask = loss_arrays()
    rows = slice(rank * 64 // world, (rank + 1) * 64 // world)
    out = {}
    for name in LOSS_NAMES:
        p = torch.tensor(pred[rows], requires_grad=True)
        loss, _ = get_loss_fn(name, group=mesh.get_group("data"))(
            p, torch.tensor(target[rows]), torch.tensor(mask[rows]))
        loss.backward()
        out[name] = (float(loss), p.grad.numpy())
    return out


def sample_noise():
    """Standard-normal noise [64 rays, N_SAMPLES] for the sample split."""
    return np.random.default_rng(12).normal(size=(64, N_SAMPLES)).astype(np.float32)


def job_sample_split(inputs, rank, world):
    """The depth-sample split over ``world`` ranks, perturb off: the
    integrals and this rank's gradient of their sum; then the integrals
    with noise (std 0.5), this rank's slab of ``sample_noise()`` fed."""
    mesh = make_mesh(MeshSpec(1, world), "cpu")
    field = tiny_field(inputs["params"])
    j, local = mesh.get_local_rank("sample"), N_SAMPLES // world
    kw = dict(n_samples=N_SAMPLES, local_samples=local, sample_index=j,
              group=mesh.get_group("sample"), perturb=False)
    rays = torch.tensor(inputs["rays"])
    acc = pstep._render_acc_sample_sharded(rays, field, raw_noise_std=0.0, **kw)
    acc.sum().backward()
    noisy = pstep._render_acc_sample_sharded(
        rays, field, raw_noise_std=0.5,
        noise=torch.tensor(sample_noise()[:, j * local:(j + 1) * local]), **kw)
    return acc.detach().numpy(), flat_grads(field), noisy.detach().numpy()


def job_layout(inputs, rank, world):
    """This rank's coordinate in every 2-D layout of ``world`` ranks."""
    return {(d, world // d): tuple(make_mesh(MeshSpec(d, world // d), "cpu")
                                   .get_coordinate())
            for d in (1, 2, world)}


def job_steps(inputs, rank, world):
    """One sharded step per layout, fed this data shard's draws of the JAX
    step: the loss and the all-reduced gradient."""
    out = {}
    for layout in STEP_LAYOUTS[world]:
        mesh = make_mesh(MeshSpec(*layout), "cpu")
        field = tiny_field(inputs["params"])
        cfg = with_defaults(tiny_cfg())
        opt = toptim.make_optimizer(cfg, field.parameters())
        fn = pstep.make_sharded_train_step(
            cfg, field, opt, mesh, 4, torch.Generator().manual_seed(0),
            n_rays=N_RAYS, n_batch=1, use_mask=False)
        d = mesh.get_local_rank("data")
        draws = inputs["steps"][layout]
        batch = {k: torch.tensor(v) for k, v in draws["batch"][d].items()}
        loss = fn(None, [0], 0, batch=batch, t_rand=torch.tensor(draws["t_rand"][d]))
        out[layout] = (float(loss), flat_grads(field))
    return out


def job_epoch(inputs, rank, world):
    """Three steps of ``make_sharded_epoch_fn`` (data=2) on the tiny
    dataset, beside the same steps of ``make_sharded_train_step`` from an
    equal field and generator: both runs' losses and parameters.  The
    table is 2^14, so the main path's plain encoder runs (its sums are
    in a fixed order; the 2^8 table's scatter on the CPU is not)."""
    mesh = make_mesh(MeshSpec(2, 1), "cpu")
    cfg = with_defaults(tiny_cfg())
    cfg["encoder"]["log2_hashmap_size"] = 14
    arrays = {k: torch.tensor(v) for k, v in inputs["arrays"].items()}
    order = [[0], [1], [2]]
    out = {}
    for name, make in (("epoch", pstep.make_sharded_epoch_fn),
                       ("steps", pstep.make_sharded_train_step)):
        field = ttrainer.build_model(cfg, torch.Generator().manual_seed(1))
        fn = make(cfg, field, toptim.make_optimizer(cfg, field.parameters()), mesh, 4,
                  torch.Generator().manual_seed(5), n_rays=N_RAYS, n_batch=1,
                  use_mask=False)
        losses = (fn(arrays, order, 0) if name == "epoch"
                  else torch.stack([fn(arrays, v, i) for i, v in enumerate(order)]))
        out[name] = (losses.numpy(), torch.cat(
            [p.detach().reshape(-1) for p in field.parameters()]).numpy())
    return out


def job_checks(inputs, rank, world):
    """The mesh's and the step body's refusals, and ``local_batch_size``."""
    data2, sample2 = make_mesh(MeshSpec(2, 1), "cpu"), make_mesh(MeshSpec(1, 2), "cpu")
    field = tiny_field(inputs["params"])
    opt = toptim.make_optimizer(with_defaults(tiny_cfg()), field.parameters())

    def body(mesh, n_rays=N_RAYS, **over):
        cfg = with_defaults(tiny_cfg())
        for section, values in over.items():
            cfg[section].update(values)
        return lambda: pstep._make_shard_body(cfg, field, opt, n_rays, 1, False, mesh)

    return {
        "world_mismatch": outcome(lambda: make_mesh(MeshSpec(4, 1), "cpu")),
        "fine_and_sample": outcome(body(sample2, render={"n_fine": 8})),
        "tv_and_sample": outcome(body(sample2, train={"loss": "mse+tv"})),
        "rays_not_divisible": outcome(body(data2, n_rays=N_RAYS - 1)),
        "samples_not_divisible": outcome(body(sample2, render={"n_samples": 15})),
        "local_1024_data": outcome(lambda: local_batch_size(1024, data2)),
        "local_1024_sample": outcome(lambda: local_batch_size(1024, sample2, "sample")),
        "local_101_data": outcome(lambda: local_batch_size(101, data2)),
    }


def job_trainer(inputs, rank, world):
    """``Trainer`` over the 2 ranks (data=2) on smoke.yaml cut for the CPU:
    two epochs with evals and a checkpoint, then a resume for a third."""
    ttrainer.ExperimentLogger = functools.partial(ExperimentLogger,
                                                  enable_tensorboard=False)
    writes = []     # every file this rank's trainer writes (not in-memory pickles)
    for mod, name in ((torch, "save"), (np, "save"), (ttrainer, "_save_png")):
        def wrapped(*a, _f=getattr(mod, name), _n=name, **kw):
            if any(isinstance(x, (str, os.PathLike)) for x in a):
                writes.append(_n)
            return _f(*a, **kw)
        setattr(mod, name, wrapped)
    workdir = inputs["workdir"]
    cfg = smoke_cfg(workdir, mesh={"data": 2})
    tr = ttrainer.Trainer(cfg, workdir=workdir, device="cpu")
    tr.start()
    first = dict(losses=list(tr.losses), global_step=tr.global_step,
                 evals=sorted(tr.eval_metrics), writes=list(writes),
                 params={k: v.numpy().copy() for k, v in tr.field.state_dict().items()},
                 logger=tr.logger is not None)
    cfg = smoke_cfg(workdir, mesh={"data": 2})
    cfg["train"].update(epoch=2, resume=True)
    cfg["log"]["i_eval"] = 0
    tr2 = ttrainer.Trainer(cfg, workdir=workdir, device="cpu")
    resumed = dict(epoch_start=tr2.epoch_start, global_step=tr2.global_step,
                   same_params=all(torch.equal(a, b) for a, b in zip(
                       tr2.field.parameters(), tr.field.parameters())))
    tr2.start()
    resumed.update(losses=list(tr2.losses), writes=list(writes),
                   params={k: v.numpy().copy() for k, v in tr2.field.state_dict().items()})
    return {"first": first, "resumed": resumed}


JOBS = {
    2: (job_losses, job_sample_split, job_steps, job_epoch, job_checks),
    4: (job_losses, job_sample_split, job_steps, job_layout),
    "trainer": (job_trainer,),
}


def rank_main(rank: int, world: int, jobs_key, store: str, in_path: str,
              out_dir: str) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        out = {job.__name__: job(inputs, rank, world) for job in JOBS[jobs_key]}
        with open(osp.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def spawn(world: int, jobs_key, inputs, tmpdir: str):
    """Run ``JOBS[jobs_key]`` on ``world`` gloo ranks; their results by rank.
    Raises if a rank fails or the spawn outlives ``JOIN_TIMEOUT_S``."""
    os.makedirs(tmpdir, exist_ok=True)
    in_path = osp.join(tmpdir, "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.start_processes(
        rank_main, args=(world, jobs_key, osp.join(tmpdir, "store"), in_path, tmpdir),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not end in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for rank in range(world):
        with open(osp.join(tmpdir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
