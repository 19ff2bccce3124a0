"""The port's sharded epoch function (``parallel/step.py::make_sharded_epoch_fn``)
on the CPU, under gloo.

- Against JAX's ``make_sharded_epoch_fn`` on a mesh of one (the first device
  of ``tests/conftest.py``'s CPU mesh) over 3 steps that cross a StepLR
  boundary (2 steps an epoch, a period of one epoch), the port on a one-rank
  gloo mesh fed JAX's draws: the pool draws and the stratified jitter
  rebuilt from JAX's key splits (a mesh of one leaves the key unfolded,
  ``parallel/step.py:204-212`` of the JAX package).  The main-path encoder
  at 3 levels x 2^14 (JAX's Pallas paths in interpret mode), 64 rays x 32
  samples.  Tolerances, those of ``tests/test_torch_parallel.py`` and
  ``tests/test_torch_epoch.py``: each loss within rtol 1e-5 (a mean of f32
  line integrals); the parameters after the epoch within 1e-3 * lr * T
  where every step's gradient is above 1e-6, and 2 * lr * T elsewhere
  (Adam moves an entry at most ~lr a step), T = 3.
- ``Trainer.train_steps`` on a mesh of one (``parallel.force_mesh``, a
  one-rank gloo group the trainer makes) goes through
  ``make_sharded_epoch_fn``; across a StepLR boundary its losses and
  parameters are ``torch.equal`` to the same mesh's eager ``train_step``
  loop and to the plain trainer.
- Two gloo ranks (``tests/_parallel_ranks.py``): data=2 and sample=2 epochs
  with equal parameters on both ranks; with the sample axis split and
  ``raw_noise_std`` > 0, every slab's noise differs from the other's and
  from step to step, and no step builds a generator.
- The step body sets no rate; the epoch is captured only on a card whose
  group runs NCCL (never under gloo, never on the CPU).
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _parallel_ranks as R
from neuralvolumetricreconstructionformedicalimages_torch.config import with_defaults as t_defaults
from neuralvolumetricreconstructionformedicalimages_torch.data import dataset as tds
from neuralvolumetricreconstructionformedicalimages_torch.models import params_from_jax
from neuralvolumetricreconstructionformedicalimages_torch.parallel import mesh as tmesh
from neuralvolumetricreconstructionformedicalimages_torch.parallel import step as pstep
from neuralvolumetricreconstructionformedicalimages_torch.train import optim as toptim
from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as ttrainer
from neuralvolumetricreconstructionformedicalimages_torch.utils.logging import (
    ExperimentLogger)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "data", "smoke.pickle")
STEPS, SPE, N_RAYS, N_SAMPLES, LR = 3, 2, 64, 32, 1e-2


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The trainer logs JSONL only here (TensorBoard's import is slow)."""
    monkeypatch.setattr(ttrainer, "ExperimentLogger",
                        functools.partial(ExperimentLogger, enable_tensorboard=False))
    monkeypatch.setattr(tmesh, "DEFAULT_TIMEOUT_S", R.GROUP_TIMEOUT_S)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group (a ``FileStore``, no port) and its mesh of one."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield tmesh.make_mesh(tmesh.MeshSpec(1, 1), "cpu")
    finally:
        dist.destroy_process_group()


def _cfg(n_batch=1, ray_mode="precomputed"):
    return {
        "exp": {"expname": "t", "expdir": ".", "datadir": SMOKE},
        "network": {"net_type": "mlp", "num_layers": 4, "hidden_dim": 16,
                    "skips": [2], "out_dim": 1, "last_activation": "sigmoid",
                    "bound": 0.3},
        "encoder": {"encoding": "hashgrid", "input_dim": 3, "num_levels": 3,
                    "level_dim": 2, "base_resolution": 8, "log2_hashmap_size": 14,
                    "forward": "sorted", "table_dtype": "bfloat16",
                    "pack_sort": True},
        "render": {"n_samples": N_SAMPLES, "n_fine": 0, "perturb": True,
                   "raw_noise_std": 0.0, "netchunk": 4096},
        "train": {"epoch": 0, "n_batch": n_batch, "n_rays": N_RAYS, "lrate": LR,
                  "lrate_gamma": 0.1, "lrate_step": 1, "resume": False,
                  "ray_mode": ray_mode},
        "log": {"i_eval": 0, "i_save": 0},
    }


def _jax_draws(key, view_order, counts, n_batch):
    """The draws of JAX's sharded epoch on a mesh of one (its key left
    unfolded): one key a step, split into pixel and render keys; one pixel
    key a view, ``randint(k, (n_rays,), 0, count)``; the render key's first
    of four splits, ``uniform`` over the sample grid."""
    import jax
    import jax.numpy as jnp

    r, t_rand = [], []
    for i, k in enumerate(jax.random.split(key, view_order.shape[0])):
        k_pix, k_render = jax.random.split(k)
        pix_keys = jax.random.split(k_pix, n_batch)
        r.append([np.asarray(jax.random.randint(pk, (N_RAYS,), 0, counts[v]))
                  for pk, v in zip(pix_keys, view_order[i])])
        t_rand.append(np.asarray(jax.random.uniform(
            jax.random.split(k_render, 4)[0], (n_batch * N_RAYS, N_SAMPLES),
            jnp.float32)))
    return {"r": np.asarray(r), "t_rand": np.asarray(t_rand)}


@pytest.mark.parametrize("n_batch,ray_mode,masked", [
    (1, "precomputed", False), (2, "onthefly", False), (2, "precomputed", True)],
    ids=["b1", "b2_onthefly", "b2_masked"])
def test_sharded_epoch_matches_jax(one_rank, n_batch, ray_mode, masked):
    import jax
    import jax.numpy as jnp

    from neuralvolumetricreconstructionformedicalimages_tpu.config import (
        with_defaults as j_defaults)
    from neuralvolumetricreconstructionformedicalimages_tpu.data import dataset as jds
    from neuralvolumetricreconstructionformedicalimages_tpu.parallel import mesh as jmesh
    from neuralvolumetricreconstructionformedicalimages_tpu.parallel import step as jstep
    from neuralvolumetricreconstructionformedicalimages_tpu.train import trainer as jtrainer

    cfg = _cfg(n_batch, ray_mode)
    cfg_j, cfg_t = j_defaults(cfg), t_defaults(cfg)
    data = tds.load_pickle(SMOKE)
    jd = jds.make_dataset(data, "train", n_rays=N_RAYS, ray_mode=ray_mode)
    td = tds.make_dataset(data, "train", n_rays=N_RAYS, ray_mode=ray_mode)
    ja, ta = jd.arrays(), td.arrays()
    if masked:   # a beam mask over about 70 % of every view
        mask = (np.random.default_rng(4).uniform(size=td.mask.shape) > 0.3
                ).astype(np.float32)
        ja["mask"], ta["mask"] = jnp.asarray(mask), torch.as_tensor(mask)
    view_order = np.arange(STEPS * n_batch).reshape(STEPS, n_batch)

    spec = jtrainer.build_model(cfg_j)
    state = jtrainer.init_state(cfg_j, spec, SPE, jax.random.key(0))
    table = state["params"]["coarse"]["encoder"]["table"]
    state["params"]["coarse"]["encoder"]["table"] = jnp.asarray(
        0.1 * np.random.default_rng(0).normal(size=table.shape).astype(np.float32))
    params0 = jax.tree.map(np.asarray, state["params"]["coarse"])
    mesh_j = jmesh.make_mesh(jmesh.MeshSpec(data=1, sample=1), devices=jax.devices()[:1])
    epoch_j = jstep.make_sharded_epoch_fn(cfg_j, spec, mesh_j, SPE, n_rays=N_RAYS,
                                          n_batch=n_batch, use_mask=masked, geo=jd.geo,
                                          near=jd.near, far=jd.far)
    key = jax.random.key(5)
    state, jlosses = epoch_j(state, ja, jnp.asarray(view_order), key)
    jparams = jax.tree.map(np.asarray, state["params"]["coarse"])

    field = ttrainer.build_model(cfg_t)
    field.load_state_dict(params_from_jax(params0))
    opt = toptim.make_optimizer(cfg_t, field.parameters())
    epoch_t = pstep.make_sharded_epoch_fn(
        cfg_t, field, opt, one_rank, SPE, None, n_rays=N_RAYS, n_batch=n_batch,
        use_mask=masked, geo=td.geo, near=td.near, far=td.far)
    grads = {name: [] for name, _ in field.named_parameters()}
    for name, p in field.named_parameters():
        p.register_hook(functools.partial(lambda n, g: grads[n].append(g.clone()), name))
    draws = _jax_draws(key, view_order, np.asarray(jd.pool_counts), n_batch)
    tlosses = epoch_t(ta, view_order, 0, draws=draws)
    assert tlosses.shape == (STEPS,) and epoch_t.graphed.graph is None
    assert opt.param_groups[0]["lr"] == pytest.approx(LR * 0.1)   # the rate fell
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=1e-5)

    want = params_from_jax(jparams)
    for name, p in field.named_parameters():
        g = torch.stack(grads[name])                       # [steps, ...]
        big = (g.abs() > 1e-6).all(0)
        d = (p.detach() - want[name]).abs()
        assert d.max() <= 2 * LR * STEPS, name
        if big.any():
            assert d[big].max() <= 1e-3 * LR * STEPS, (name, float(d[big].max()))


def test_mesh_trainer_runs_the_sharded_epoch_fn(tmp_path, no_tensorboard, monkeypatch):
    """The mesh branch of ``Trainer`` builds ``make_sharded_epoch_fn`` and
    ``train_steps`` calls what it returned, once for the whole view order."""
    made, calls = [], []
    real = pstep.make_sharded_epoch_fn

    def spy(*a, **kw):
        fn = real(*a, **kw)
        made.append(fn)

        def wrapped(*b, **bkw):
            calls.append(len(b[1]))
            return fn(*b, **bkw)

        wrapped.__dict__.update(fn.__dict__)
        return wrapped

    monkeypatch.setattr(pstep, "make_sharded_epoch_fn", spy)
    cfg = R.smoke_cfg(str(tmp_path), **R.MESH1)
    cfg["log"].update(i_eval=0, i_save=0)
    tr = ttrainer.Trainer(cfg, workdir=str(tmp_path), device="cpu")
    try:
        assert len(made) == 1 and tr.generator is made[0].generator
        losses = tr.train_steps(tr._view_order(0)[:3])
    finally:
        tr.close()
    assert calls == [3] and losses.shape == (3,) and tr.global_step == 3


@pytest.mark.parametrize("n_batch", [1, 2])
def test_mesh_epoch_equals_eager_loop_and_plain(tmp_path, no_tensorboard, n_batch):
    """Across a StepLR boundary: a mesh of one's ``train_steps`` (eager by
    backend: gloo, CPU) ``torch.equal`` to its eager ``train_step`` loop and
    to the plain trainer, losses and parameters."""
    runs = R.epoch_runs(tmp_path, "cpu", n_batch)
    assert not dist.is_initialized()
    rates = runs["mesh"][3]
    assert rates[0] == rates[1] > rates[2] == rates[3]      # the rate falls at step 3
    for name in ("mesh_eager", "plain"):
        assert torch.equal(runs["mesh"][0], runs[name][0]), (name, runs)
        for a, b in zip(runs["mesh"][1], runs[name][1]):
            assert torch.equal(a, b), name
    assert all(run[2] is None for run in runs.values())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One run of ``_parallel_ranks.job_sharded_epochs`` on 2 gloo ranks."""
    tmp = tmp_path_factory.mktemp("epochs2")
    out = R.spawn(2, "epochs", {"arrays": R.tiny_arrays()}, str(tmp))
    return [o["job_sharded_epochs"] for o in out]


@pytest.mark.parametrize("layout", ["data2", "sample2"])
def test_two_ranks_epoch_agree(two_ranks, layout):
    """Both ranks read the same finite global losses and hold the same
    parameters after the epoch, bit for bit; nothing was captured."""
    r0, r1 = (r[layout] for r in two_ranks)
    assert r0["losses"].shape == (STEPS,) and np.isfinite(r0["losses"]).all()
    assert np.array_equal(r0["losses"], r1["losses"])
    assert r0["checksum"] == r1["checksum"]
    assert not r0["graph"] and not r1["graph"]


def test_sample_noise_differs_per_slab_and_step(two_ranks):
    """The sample axis's noise generator, folded once per rank when the
    step is built: 3 draws a rank (one a step, none of them by a generator
    made in a step), each slab's unlike the other slab's, each step's
    unlike the last; ``refold_noise`` folds it again from the draw
    generator's state (what a restore calls)."""
    noise = [r["sample2"]["noise"] for r in two_ranks]
    assert all(r["sample2"]["noise_generator"] for r in two_ranks)
    assert all(r["sample2"]["refolded"] for r in two_ranks)
    assert not any(r["data2"]["noise_generator"] for r in two_ranks)
    assert [len(n) for n in noise] == [STEPS, STEPS]
    assert noise[0][0].shape == (R.N_RAYS, R.N_SAMPLES // 2)
    for i in range(STEPS):
        assert not np.array_equal(noise[0][i], noise[1][i]), i
        for n in noise:
            if i:
                assert not np.array_equal(n[i], n[i - 1]), i


def test_step_body_sets_no_rate(one_rank):
    """The per-rank step applies the rate the optimizer holds and sets
    none: at rate 0 Adam leaves the parameters as they were; at the
    schedule's rate, filled in by the caller, it moves them."""
    cfg = t_defaults(R.tiny_cfg())
    field = ttrainer.build_model(cfg, torch.Generator().manual_seed(1))
    opt = toptim.make_optimizer(cfg, field.parameters())
    body = pstep._make_shard_body(cfg, field, opt, R.N_RAYS, 1, False, one_rank,
                                  torch.Generator().manual_seed(2))
    arrays = {k: torch.tensor(v) for k, v in R.tiny_arrays().items()}
    before = [p.detach().clone() for p in field.parameters()]
    toptim.set_lr(opt, 0.0)
    body(arrays, torch.tensor([0]))
    assert opt.param_groups[0]["lr"] == 0.0
    assert all(torch.equal(a, p) for a, p in zip(before, field.parameters()))
    toptim.set_lr(opt, 1e-2)
    body(arrays, torch.tensor([1]))
    assert opt.param_groups[0]["lr"] == 1e-2
    assert not all(torch.equal(a, p) for a, p in zip(before, field.parameters()))


@pytest.mark.parametrize("backend,captured", [
    ("nccl", True), ("cpu:gloo,cuda:nccl", True), ("gloo", False),
    ("cpu:gloo,cuda:gloo", False)])
def test_capture_follows_the_backend(monkeypatch, backend, captured):
    """The sharded step is captured on a card whose group runs NCCL, and
    never under gloo, never on the CPU."""
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    assert pstep.graphs_collectives(torch.device("cuda", 0)) is captured
    assert pstep.graphs_collectives(torch.device("cpu")) is False


def test_gloo_epoch_is_never_captured(one_rank, monkeypatch):
    """Under a real gloo group no device is captured, and the epoch runs
    its steps eagerly: ``_GraphedStep`` is never called."""
    assert not pstep.graphs_collectives(torch.device("cuda", 0))

    def refuse(self, *a, **kw):
        raise AssertionError("a gloo epoch reached the CUDA graph")

    monkeypatch.setattr(ttrainer._GraphedStep, "__call__", refuse)
    cfg = t_defaults(R.tiny_cfg())
    field = ttrainer.build_model(cfg, torch.Generator().manual_seed(1))
    fn = pstep.make_sharded_epoch_fn(
        cfg, field, toptim.make_optimizer(cfg, field.parameters()), one_rank, 2,
        torch.Generator().manual_seed(5), n_rays=R.N_RAYS, n_batch=1, use_mask=False)
    arrays = {k: torch.tensor(v) for k, v in R.tiny_arrays().items()}
    losses = fn(arrays, [[0], [1], [2]], 0)
    assert losses.shape == (3,) and torch.isfinite(losses).all()
    assert fn.graphed.graph is None
