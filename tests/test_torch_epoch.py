"""The port's epoch function (``train/trainer.py::make_epoch_fn``) on the CPU.

- Against JAX's ``make_epoch_fn`` over one epoch of 3 steps (the main-path
  encoder at 3 levels x 2^14, so that JAX takes its Pallas paths in
  interpret mode; 64 rays x 32 samples), the port fed JAX's own draws:
  the pool draws and the stratified jitter are rebuilt from JAX's key
  splits (``train/trainer.py:133-141,157``, ``data/dataset.py:131``,
  ``render.py:56``, ``ops/sampling.py:31``).  n_batch 1 and 2, rays
  precomputed and made on the fly, a beam mask.  Tolerances: each step's
  loss within rtol 1e-5 (a mean of f32 line integrals, as for one step in
  ``tests/test_torch_train.py``); parameters after the epoch within that
  file's one-step Adam tolerances scaled by the step count T = 3: 1e-3 * lr
  * T where every step's gradient is well above eps (|g| > 1e-6 in every
  step), 2 * lr * T elsewhere (Adam moves any entry at most ~lr a step).
- Against the port's own eager step loop (``Trainer.train_step``):
  ``torch.equal`` losses and parameters from one seed, also with the fine
  pass (``n_fine: 2``) and with rays on the fly.
- The batched gather (``data/dataset.py::gather_batch``) bit-equal to the
  per-view ``gather_view_batch`` loop and concatenation, in both ray modes.
- The step constants cached on a device: each equals its NumPy value, and a
  second call with the same (spec, device) returns the same tensor.
"""

import functools
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu.config import with_defaults as j_defaults  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.data import dataset as jds  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.train import trainer as jtrainer  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch import geometry as G  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.config import with_defaults as t_defaults  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.data import dataset as tds  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.models import params_from_jax  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import coherent_hash as ch  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import hash_encoding as he  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.train import optim as toptim  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as ttrainer  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.utils.logging import (  # noqa: E402
    ExperimentLogger,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "data", "smoke.pickle")
STEPS, N_RAYS, N_SAMPLES, LR = 3, 64, 32, 1e-2


def _cfg(n_batch=1, ray_mode="precomputed", n_fine=0, epoch=0):
    return {
        "exp": {"expname": "t", "expdir": ".", "datadir": SMOKE},
        "network": {"net_type": "mlp", "num_layers": 4, "hidden_dim": 16,
                    "skips": [2], "out_dim": 1, "last_activation": "sigmoid",
                    "bound": 0.3},
        "encoder": {"encoding": "hashgrid", "input_dim": 3, "num_levels": 3,
                    "level_dim": 2, "base_resolution": 8, "log2_hashmap_size": 14,
                    "forward": "sorted", "table_dtype": "bfloat16",
                    "pack_sort": True},
        "render": {"n_samples": N_SAMPLES, "n_fine": n_fine, "perturb": True,
                   "raw_noise_std": 0.0, "netchunk": 4096},
        "train": {"epoch": epoch, "n_batch": n_batch, "n_rays": N_RAYS, "lrate": LR,
                  "lrate_gamma": 0.1, "lrate_step": 10, "resume": False,
                  "ray_mode": ray_mode},
        "log": {"i_eval": 0, "i_save": 0},
    }


@pytest.fixture(scope="module")
def smoke_data():
    return tds.load_pickle(SMOKE)


def _jax_draws(key, view_order, counts, n_batch):
    """The pool draws [steps, n_batch, n_rays] and the jitter [steps,
    n_batch * n_rays, n_samples] that JAX's epoch function draws from
    ``key``: split per step, then into pixel and render keys; one pixel
    key a view, ``randint(k, (n_rays,), 0, count)``; the render key's first
    of four splits, ``uniform`` over the sample grid."""
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
    (1, "precomputed", False), (2, "precomputed", False), (2, "onthefly", False),
    (1, "precomputed", True), (2, "onthefly", True)],
    ids=["b1", "b2", "b2_onthefly", "b1_masked", "b2_onthefly_masked"])
def test_epoch_matches_jax(smoke_data, n_batch, ray_mode, masked):
    cfg = _cfg(n_batch, ray_mode)
    cfg_j, cfg_t = j_defaults(cfg), t_defaults(cfg)
    jd = jds.make_dataset(smoke_data, "train", n_rays=N_RAYS, ray_mode=ray_mode)
    td = tds.make_dataset(smoke_data, "train", n_rays=N_RAYS, ray_mode=ray_mode)
    ja, ta = jd.arrays(), td.arrays()
    if masked:   # a beam mask over about 70 % of every view
        mask = (np.random.default_rng(4).uniform(size=td.mask.shape) > 0.3
                ).astype(np.float32)
        ja["mask"], ta["mask"] = jnp.asarray(mask), torch.as_tensor(mask)
    spe = td.n_views // n_batch
    view_order = np.arange(STEPS * n_batch).reshape(STEPS, n_batch)

    spec = jtrainer.build_model(cfg_j)
    state = jtrainer.init_state(cfg_j, spec, spe, jax.random.key(0))
    table = state["params"]["coarse"]["encoder"]["table"]
    state["params"]["coarse"]["encoder"]["table"] = jnp.asarray(
        0.1 * np.random.default_rng(0).normal(size=table.shape).astype(np.float32))
    params0 = jax.tree.map(np.asarray, state["params"]["coarse"])
    epoch_j = jtrainer.make_epoch_fn(cfg_j, spec, spe, N_RAYS, n_batch, masked,
                                     geo=jd.geo, near=jd.near, far=jd.far)
    key = jax.random.key(5)
    state, jlosses = epoch_j(state, ja, jnp.asarray(view_order), key)
    jparams = jax.tree.map(np.asarray, state["params"]["coarse"])

    field = ttrainer.build_model(cfg_t)
    field.load_state_dict(params_from_jax(params0))
    opt = toptim.make_optimizer(cfg_t, field.parameters())
    epoch_t = ttrainer.make_epoch_fn(
        cfg_t, field, opt, spe, n_rays=N_RAYS, n_batch=n_batch, use_mask=masked,
        generator=None, geo=td.geo, near=td.near, far=td.far)
    grads = {name: [] for name, _ in field.named_parameters()}
    for name, p in field.named_parameters():
        p.register_hook(functools.partial(lambda n, g: grads[n].append(g.clone()), name))
    draws = _jax_draws(key, view_order, np.asarray(jd.pool_counts), n_batch)
    tlosses = epoch_t(ta, view_order, 0, draws=draws)
    assert tlosses.shape == (STEPS,)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=1e-5)

    want = params_from_jax(jparams)
    for name, p in field.named_parameters():
        g = torch.stack(grads[name])                       # [steps, ...]
        big = (g.abs() > 1e-6).all(0)
        d = (p.detach() - want[name]).abs()
        assert d.max() <= 2 * LR * STEPS, name
        if big.any():
            assert d[big].max() <= 1e-3 * LR * STEPS, (name, float(d[big].max()))


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The trainer logs JSONL only here (TensorBoard's import is slow)."""
    monkeypatch.setattr(ttrainer, "ExperimentLogger",
                        functools.partial(ExperimentLogger, enable_tensorboard=False))


@pytest.mark.parametrize("n_batch,ray_mode,n_fine", [
    (1, "precomputed", 0), (1, "precomputed", 2), (2, "onthefly", 2)],
    ids=["sorted", "n_fine2", "b2_onthefly_n_fine2"])
def test_epoch_equals_eager_loop(tmp_path, no_tensorboard, n_batch, ray_mode, n_fine):
    """``Trainer.train_steps`` (the epoch function) and the ``train_step``
    loop of a second trainer from the same seed: ``torch.equal``."""
    cfg = _cfg(n_batch, ray_mode, n_fine)
    a = ttrainer.Trainer(cfg, workdir=str(tmp_path / "a"), device="cpu")
    b = ttrainer.Trainer(cfg, workdir=str(tmp_path / "b"), device="cpu")
    order = a._view_order(0)[:STEPS]
    la = a.train_steps(order)
    lb = torch.stack([b.train_step(v) for v in order])
    assert torch.equal(la, lb), (la, lb)
    assert a.global_step == b.global_step == STEPS
    for p, q in zip(a._parameters(), b._parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("fed", [True, False], ids=["fed_r", "generator"])
@pytest.mark.parametrize("ray_mode", ["precomputed", "onthefly"])
def test_gather_batch_equals_per_view_loop(smoke_data, ray_mode, fed):
    ds = tds.make_dataset(smoke_data, "train", n_rays=N_RAYS, ray_mode=ray_mode)
    arrays, views = ds.arrays(), [7, 2, 7, 19]
    kw = dict(geo=ds.geo, near=ds.near, far=ds.far)
    r = None
    if fed:
        rng = np.random.default_rng(3)
        r = torch.as_tensor(np.stack([rng.integers(0, int(ds.pool_counts[v]), N_RAYS)
                                      for v in views]))
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    parts = [tds.gather_view_batch(arrays, v, N_RAYS, g1,
                                   r=None if r is None else r[i], **kw)
             for i, v in enumerate(views)]
    batch = tds.gather_batch(arrays, torch.tensor(views), N_RAYS, g2, r=r, **kw)
    for k in ("rays", "projs", "mask", "pix"):
        assert torch.equal(batch[k], torch.cat([p[k] for p in parts])), k
    assert batch["rays"].shape == (len(views) * N_RAYS, 8)


def test_step_constants_cached_on_device():
    spec = he.HashGridSpec(num_levels=5, base_resolution=4, log2_hashmap_size=14)
    dev = torch.device("cpu")
    res_p1 = (spec.resolutions + 1).astype(np.uint64)
    strides = (np.stack([res_p1 ** d for d in range(3)], -1) & 0xFFFFFFFF).astype(np.int64)
    phi = np.pi / 2
    r1 = np.array([[1, 0, 0], [0, np.cos(-phi), -np.sin(-phi)],
                   [0, np.sin(-phi), np.cos(-phi)]], np.float32)
    r2 = np.array([[np.cos(phi), -np.sin(phi), 0], [np.sin(phi), np.cos(phi), 0],
                   [0, 0, 1]], np.float32)
    cases = [
        (he._scales_on, (spec, dev), spec.scales, torch.float32),
        (he._strides_on, (spec, dev), strides, torch.int64),
        (he._dense_on, (spec, dev), spec.dense_levels, torch.bool),
        (ch._mult_on, (spec, dev), ch.multipliers(spec).view(np.uint32).astype(np.int64),
         torch.int64),
        (ch._bits_on, (3, dev), ch.corner_bits(3), torch.int32),
        (ch._offsets_on, (spec, dev), ch.corner_offsets(spec), torch.int32),
        (sg._pack_hi_on, (dev,), np.array([2047.0, 2047.0, 1023.0], np.float32),
         torch.float32),
        (G._r21_on, (dev,), (r2 @ r1).astype(np.float64), torch.float64),
    ]
    for fn, args, want, dtype in cases:
        t = fn(*args)
        assert t.dtype == dtype and t.device == dev, fn.__name__
        np.testing.assert_array_equal(t.numpy(), want, fn.__name__)
        assert fn(*args) is t, fn.__name__


def test_pack_rays_fills_near_far_on_device():
    """``pack_rays`` fills near/far on the rays' device: the same f32 values
    as a tensor made from the host floats."""
    rng = np.random.default_rng(0)
    ro, rd = (torch.as_tensor(rng.normal(size=(5, 7, 3)).astype(np.float32)) for _ in "od")
    near, far = 0.3176543210123, 1.7000000001
    out = G.pack_rays(ro, rd, near, far)
    nf = torch.tensor([near, far], dtype=torch.float32).expand(5, 7, 2)
    assert torch.equal(out, torch.cat([ro, rd, nf], -1))


def test_set_lr_fills_a_device_rate_in_place():
    p = torch.nn.Parameter(torch.ones(3))
    lr = torch.tensor(1e-3)
    opt = torch.optim.Adam([p], lr=lr)
    toptim.set_lr(opt, 2.5e-4)
    assert opt.param_groups[0]["lr"] is lr and float(lr) == np.float32(2.5e-4)
    cpu = toptim.make_optimizer(t_defaults(_cfg()), [p])
    assert cpu.param_groups[0]["lr"] == LR and not cpu.defaults["capturable"]
    toptim.set_lr(cpu, 5e-3)
    assert cpu.param_groups[0]["lr"] == 5e-3


def test_epoch_fn_refuses_unknown_draws(smoke_data):
    cfg = t_defaults(_cfg())
    ds = tds.make_dataset(smoke_data, "train", n_rays=N_RAYS)
    field = ttrainer.build_model(cfg)
    fn = ttrainer.make_epoch_fn(cfg, field, toptim.make_optimizer(cfg, field.parameters()),
                                20, n_rays=N_RAYS, n_batch=1, use_mask=False,
                                generator=None)
    with pytest.raises(ValueError, match="unknown draws"):
        fn(ds.arrays(), np.zeros((1, 1), np.int64), 0, draws={"u": np.zeros((1, 3))})
