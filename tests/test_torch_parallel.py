"""Port parity of the parallel layer (``parallel/mesh.py``,
``parallel/step.py``, ``losses.get_loss_fn(name, group)``) against the JAX
package's ``parallel/`` on its 8-device CPU mesh.

The port's ranks are processes under gloo (``tests/_parallel_ranks.py``,
one spawn a world size, shared by the cases through module fixtures);
JAX is imported only inside the fixtures and tests, since every rank
imports this file's helpers and must not load it.

Tolerances, with their reasons: a global loss is one f32 division of
all-reduced f32 sums, in another order than the unsharded sum (rtol
1e-6); a loss through the renderer is a mean of f32 line integrals (rtol
1e-5, as ``tests/test_torch_train.py``); gradients of the step follow
``tests/test_torch_train.py::test_one_training_step_matches_jax``: the
table to 1e-3 and the MLP to 1e-4 of the largest entry; gradients w.r.t.
``pred`` are f32 quotients (atol 1e-6 of the largest entry).
"""

import numpy as np
import pytest

import _parallel_ranks as R
from neuralvolumetricreconstructionformedicalimages_torch.parallel import mesh as tmesh

STEP_CASES = [(2, (2, 1)), (4, (2, 2)), (2, (1, 2))]


# ------------------------------------------------------------- JAX side

def _jax_cfg(perturb=True):
    from neuralvolumetricreconstructionformedicalimages_tpu.config import with_defaults
    return with_defaults(R.tiny_cfg(perturb=perturb))


def _jax_arrays():
    """``tests/test_parallel.py``'s synthetic packed dataset (4 views of
    8 x 8, a tilted parallel beam)."""
    import jax
    import jax.numpy as jnp

    from neuralvolumetricreconstructionformedicalimages_tpu import geometry as G
    geo = G.ConeGeometry(
        DSD=1.5, DSO=1.0, nDetector=(8, 8), dDetector=(0.01, 0.01),
        nVoxel=(8, 8, 8), dVoxel=(0.01, 0.01, 0.01), mode="parallel",
        tilt_angle=10.0)
    angles = np.linspace(0, np.pi, 4, endpoint=False).astype(np.float32)
    near, far = G.get_near_far(geo)
    ro, rd = G.rays_for_angles(geo, angles)
    return {
        "rays": G.pack_rays(ro, rd, near, far),
        "projs": jax.random.uniform(jax.random.key(1), (4, 8, 8)) * 0.1 + 0.01,
        "mask": jnp.ones((4, 8, 8), jnp.float32),
        "pools": jnp.broadcast_to(jnp.arange(64, dtype=jnp.int32), (4, 64)),
        "pool_counts": jnp.full((4,), 64, jnp.int32),
    }


def _jax_mesh(data, sample):
    import jax

    from neuralvolumetricreconstructionformedicalimages_tpu.parallel import mesh as jmesh
    return jmesh.make_mesh(jmesh.MeshSpec(data=data, sample=sample),
                           devices=jax.devices()[:data * sample])


def _jax_draws(arrays, key, n_data, n_sample):
    """Each data shard's batch and stratified jitter as the JAX step draws
    them (``step.py:208-217``; ``render.py`` splits its key in 4, the
    sample-sharded renderer in 2)."""
    import jax
    import jax.numpy as jnp

    from neuralvolumetricreconstructionformedicalimages_tpu.data.dataset import (
        gather_view_batch)
    local = R.N_RAYS // n_data
    batches, t_rands = [], []
    for d in range(n_data):
        k = key if n_data == 1 else jax.random.fold_in(key, d)
        k_pix, k_render = jax.random.split(k)
        b = gather_view_batch(arrays, jnp.int32(0), jax.random.split(k_pix, 1)[0], local)
        k_strat = jax.random.split(k_render, 4 if n_sample == 1 else 2)[0]
        batches.append({k: np.asarray(b[k]) for k in ("rays", "projs", "mask")})
        t_rands.append(np.asarray(jax.random.uniform(
            k_strat, (local, R.N_SAMPLES), jnp.float32)))
    return {"batch": batches, "t_rand": t_rands}


def _jax_acc(params, spec, rays, t_rand):
    """The coarse pass of ``render_rays`` with the jitter fed in."""
    import jax.numpy as jnp

    from neuralvolumetricreconstructionformedicalimages_tpu.ops.integration import (
        raw2outputs)
    near, far = rays[:, 6:7], rays[:, 7:8]
    t = jnp.linspace(0.0, 1.0, t_rand.shape[-1], dtype=jnp.float32)
    z = near * (1.0 - t) + far * t
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = jnp.concatenate([mids, z[..., -1:]], axis=-1)
    lower = jnp.concatenate([z[..., :1], mids], axis=-1)
    z = lower + (upper - lower) * t_rand
    b = spec.bound - 1e-6
    pts = jnp.clip(rays[:, None, :3] + rays[:, None, 3:6] * z[..., None], -b, b)
    return raw2outputs(spec.apply(params, pts), z, rays[:, 3:6])[0]


@pytest.fixture(scope="module")
def jax_side():
    """The tiny model's params (a random table), the arrays, and every
    layout's draws from one step key."""
    import jax
    import jax.numpy as jnp

    from neuralvolumetricreconstructionformedicalimages_tpu.train.trainer import (
        build_model)
    spec = build_model(_jax_cfg())
    params = spec.init(jax.random.key(0))
    params["encoder"]["table"] = jnp.asarray(0.1 * np.random.default_rng(0).normal(
        size=params["encoder"]["table"].shape).astype(np.float32))
    arrays = _jax_arrays()
    key = jax.random.key(3)
    layouts = {lay for lays in R.STEP_LAYOUTS.values() for lay in lays}
    return dict(spec=spec, params=params, arrays=arrays, key=key,
                np_params=jax.tree.map(np.asarray, params),
                rays=np.asarray(arrays["rays"]).reshape(-1, 8)[:64],
                steps={lay: _jax_draws(arrays, key, *lay) for lay in layouts})


def _spawn(world, jax_side, tmp_path_factory):
    inputs = {k: jax_side[k] for k in ("rays", "steps")}
    inputs["params"] = jax_side["np_params"]
    inputs["arrays"] = {k: np.asarray(v) for k, v in jax_side["arrays"].items()}
    return R.spawn(world, world, inputs, str(tmp_path_factory.mktemp(f"world{world}")))


@pytest.fixture(scope="module")
def world2(jax_side, tmp_path_factory):
    return _spawn(2, jax_side, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(jax_side, tmp_path_factory):
    return _spawn(4, jax_side, tmp_path_factory)


def _ranks(request, world):
    return request.getfixturevalue(f"world{world}")


# ---------------------------------------------------------------- mesh

def test_exports_match_jax():
    from neuralvolumetricreconstructionformedicalimages_torch import parallel as tpar
    from neuralvolumetricreconstructionformedicalimages_tpu import parallel as jpar
    assert tpar.__all__ == jpar.__all__
    assert all(callable(getattr(tpar, n)) for n in tpar.__all__)


def test_rank_layout_is_jax_reshape(world4):
    """Rank r sits at (r // sample, r % sample), JAX's reshape(data, sample)."""
    for r, out in enumerate(world4):
        for (d, smp), coord in out["job_layout"].items():
            assert coord == (r // smp, r % smp), (r, d, smp, coord)


def test_fold_generator():
    """Equal states and indices give equal streams, other indices (or
    states) others; the parent is not advanced."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.parallel.step import (
        fold_generator)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    a, b, c = (torch.rand(8, generator=fold_generator(g, i)) for i in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(g.get_state(), state)
    torch.rand(1, generator=g)
    assert not torch.equal(torch.rand(8, generator=fold_generator(g, 0)), a)

@pytest.mark.parametrize("mesh_cfg", [None, {}, {"data": 4, "sample": 2}])
def test_mesh_spec_from_config_matches_jax(mesh_cfg):
    from neuralvolumetricreconstructionformedicalimages_tpu.parallel import mesh as jmesh
    j, t = jmesh.MeshSpec.from_config(mesh_cfg), tmesh.MeshSpec.from_config(mesh_cfg)
    assert (t.data, t.sample, t.n_devices, tuple(t.axis_names)) == \
        (j.data, j.sample, j.n_devices, tuple(j.axis_names))
    assert (tmesh.DATA_AXIS, tmesh.SAMPLE_AXIS) == (jmesh.DATA_AXIS, jmesh.SAMPLE_AXIS)


def test_local_batch_size_matches_jax(world2):
    """The same sizes and the same error on a (2, 1) and a (1, 2) mesh."""
    from neuralvolumetricreconstructionformedicalimages_tpu.parallel import mesh as jmesh
    checks = world2[0]["job_checks"]
    assert checks["local_1024_data"] == ("ok", jmesh.local_batch_size(1024, _jax_mesh(2, 1)))
    assert checks["local_1024_sample"] == (
        "ok", jmesh.local_batch_size(1024, _jax_mesh(1, 2), "sample"))
    with pytest.raises(ValueError) as exc:
        jmesh.local_batch_size(101, _jax_mesh(2, 1))
    assert checks["local_101_data"] == ("ValueError", str(exc.value))


@pytest.mark.parametrize("check, error, words", [
    ("world_mismatch", "ValueError", "needs 4 devices"),
    ("fine_and_sample", "NotImplementedError", "hierarchical fine pass"),
    ("tv_and_sample", "NotImplementedError", "tv regularizer"),
    ("rays_not_divisible", "ValueError", "n_rays=127 not divisible by data axis 2"),
    ("samples_not_divisible", "ValueError", "n_samples=15 not divisible by sample axis 2"),
])
def test_refusals(world2, check, error, words):
    """``make_mesh`` refuses a world that is not the mesh; the step body
    refuses what the JAX body refuses, with the same exception types."""
    for rank in world2:
        kind, msg = rank["job_checks"][check]
        assert kind == error and words in msg, (kind, msg)


# --------------------------------------------------------------- losses

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", R.LOSS_NAMES)
def test_global_loss_matches_jax(request, world, name):
    """Rows split over the ranks, a non-uniform mask: every rank's value is
    JAX's ``get_loss_fn(name, axis_name)`` under shard_map and the
    unsharded loss; the ranks' gradients w.r.t. ``pred`` sum to the
    unsharded gradient."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from neuralvolumetricreconstructionformedicalimages_tpu.losses import get_loss_fn
    pred, target, mask = (jnp.asarray(a) for a in R.loss_arrays())
    ref = get_loss_fn(name)
    ref_loss, ref_grad = jax.value_and_grad(lambda p: ref(p, target, mask)[0])(pred)
    sharded = get_loss_fn(name, axis_name="data")
    j_loss = jax.shard_map(lambda p, t, m: sharded(p, t, m)[0], mesh=_jax_mesh(world, 1),
                           in_specs=(P("data"),) * 3, out_specs=P())(pred, target, mask)
    ranks = _ranks(request, world)
    grad = np.zeros(pred.shape, np.float32)
    for r, out in enumerate(ranks):
        value, g = out["job_losses"][name]
        np.testing.assert_allclose(value, float(j_loss), rtol=1e-6)
        np.testing.assert_allclose(value, float(ref_loss), rtol=1e-6)
        grad[r * 64 // world:(r + 1) * 64 // world] += g
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(grad, ref_grad, rtol=0,
                               atol=1e-6 * max(np.abs(ref_grad).max(), 1e-30))


# --------------------------------------------------------- sample split

@pytest.mark.parametrize("world", [2, 4])
def test_sample_split_matches_jax_and_unsharded(request, jax_side, world):
    """perturb off: the integrals over ``world`` z-slabs equal JAX's
    ``_render_acc_sample_sharded`` under shard_map and the port's unsharded
    ``render_rays``; the ranks' gradients sum to the unsharded one; with
    noise fed slab by slab, they equal ``render_rays`` fed the whole
    grid's noise."""
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import PartitionSpec as P

    from neuralvolumetricreconstructionformedicalimages_torch.render import render_rays
    from neuralvolumetricreconstructionformedicalimages_tpu.parallel import step as jstep
    spec, params = jax_side["spec"], jax_side["params"]
    rays = jnp.asarray(jax_side["rays"])

    def body(r, p):
        return jstep._render_acc_sample_sharded(
            r, p, spec, n_samples=R.N_SAMPLES, local_samples=R.N_SAMPLES // world,
            perturb=False, raw_noise_std=0.0, key=None)

    j_acc = np.asarray(jax.jit(jax.shard_map(
        body, mesh=_jax_mesh(1, world), in_specs=(P(), P()),
        out_specs=P("data")))(rays, params))   # data=1: the whole array
    field = R.tiny_field(jax_side["np_params"])
    t_acc = render_rays(torch.tensor(jax_side["rays"]), field, n_samples=R.N_SAMPLES,
                        perturb=False)["acc"]
    t_acc.sum().backward()
    t_noisy = render_rays(torch.tensor(jax_side["rays"]), field, n_samples=R.N_SAMPLES,
                          perturb=False, raw_noise_std=0.5,
                          noise=torch.tensor(R.sample_noise()))["acc"].detach().numpy()
    ranks = _ranks(request, world)
    for out in ranks:
        acc, _, noisy = out["job_sample_split"]
        np.testing.assert_allclose(acc, j_acc, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(acc, t_acc.detach().numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(noisy, t_noisy, rtol=1e-5, atol=1e-6)
    grad = sum(out["job_sample_split"][1] for out in ranks)
    ref = R.flat_grads(field)
    np.testing.assert_allclose(grad, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------- sharded step

def test_sharded_epoch_is_its_steps(world2):
    """``make_sharded_epoch_fn`` runs the steps of
    ``make_sharded_train_step``: the same losses and parameters, bit for
    bit, from an equal field and generator; both ranks agree."""
    for out in world2:
        epoch, steps = out["job_epoch"]["epoch"], out["job_epoch"]["steps"]
        assert epoch[0].shape == (3,) and np.isfinite(epoch[0]).all()
        assert np.array_equal(epoch[0], steps[0]) and np.array_equal(epoch[1], steps[1])
    assert np.array_equal(world2[0]["job_epoch"]["epoch"][1],
                          world2[1]["job_epoch"]["epoch"][1])

def _jax_step(jax_side, layout, opt):
    """JAX's sharded step body with ``opt``, under shard_map: the loss and
    the params after one update."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from neuralvolumetricreconstructionformedicalimages_tpu.parallel import step as jstep
    spec, params = jax_side["spec"], jax_side["params"]
    body = jstep._make_shard_body(_jax_cfg(), spec, opt, R.N_RAYS, 1, False, *layout)
    fn = jax.jit(jax.shard_map(body, mesh=_jax_mesh(*layout), in_specs=(P(),) * 4,
                               out_specs=(P(), P()), check_vma=jstep._check_vma(spec)))
    p = {"coarse": params}
    state = {"params": p, "opt_state": opt.init(p), "step": jnp.int32(0)}
    new, loss = fn(state, jax_side["arrays"], jnp.zeros((1,), jnp.int32), jax_side["key"])
    return float(loss), new["params"]["coarse"]


def _jax_true_grad(jax_side, layout):
    """``value_and_grad`` of the unsharded loss on the data shards'
    concatenated batch and jitter."""
    import jax
    import jax.numpy as jnp

    from neuralvolumetricreconstructionformedicalimages_tpu.losses import get_loss_fn
    draws = jax_side["steps"][layout]
    rays = jnp.concatenate([b["rays"] for b in draws["batch"]])
    projs = jnp.concatenate([b["projs"] for b in draws["batch"]])
    t_rand = jnp.concatenate(draws["t_rand"])
    spec = jax_side["spec"]

    def loss(p):
        return get_loss_fn("mse")(_jax_acc(p, spec, rays, t_rand), projs, None)[0]

    return jax.value_and_grad(loss)(jax_side["params"])


def _flat(tree):
    """JAX params in ``DensityField.parameters()`` order: table, then each
    layer's (transposed) weight and bias."""
    return np.concatenate(
        [np.asarray(tree["encoder"]["table"]).reshape(-1)]
        + [a for layer in tree["layers"]
           for a in (np.asarray(layer["w"]).T.reshape(-1), np.asarray(layer["b"]))])


def _ratio(a, b):
    return float(np.dot(a, b) / np.dot(b, b))


@pytest.mark.parametrize("world, layout", STEP_CASES)
def test_sharded_step_matches_jax(request, jax_side, world, layout):
    """Fed the draws of JAX's step: the port's loss is JAX's sharded loss
    and its all-reduced gradient is JAX's gradient of that loss on the
    concatenated batch, on every rank."""
    import optax
    j_loss, _ = _jax_step(jax_side, layout, optax.sgd(1.0))
    ref_loss, ref_grad = _jax_true_grad(jax_side, layout)
    np.testing.assert_allclose(j_loss, float(ref_loss), rtol=1e-5)
    n_table = np.asarray(ref_grad["encoder"]["table"]).size
    ref = _flat(ref_grad)
    for out in _ranks(request, world):
        loss, grad = out["job_steps"][layout]
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
        np.testing.assert_allclose(grad[:n_table], ref[:n_table], rtol=0,
                                   atol=1e-3 * np.abs(ref[:n_table]).max())
        np.testing.assert_allclose(grad[n_table:], ref[n_table:], rtol=0,
                                   atol=1e-4 * np.abs(ref[n_table:]).max())


@pytest.mark.parametrize("world, layout", STEP_CASES)
def test_jax_applies_a_multiple_of_the_gradient(request, jax_side, world, layout):
    """The JAX step's gradient-scale fault (``step.py:219-224``): through
    ``_make_shard_body`` with ``optax.sgd(1.0)`` it applies ``data *
    sample`` times the gradient of the loss it reports, since the psum of
    the loss already made its gradient the sum.  The port applies it
    once."""
    import optax
    _, new = _jax_step(jax_side, layout, optax.sgd(1.0))
    _, ref_grad = _jax_true_grad(jax_side, layout)
    ref = _flat(ref_grad)
    applied = _flat(jax_side["params"]) - _flat(new)
    n = layout[0] * layout[1]
    assert abs(_ratio(applied, ref) - n) < 1e-2 * n
    for out in _ranks(request, world):
        assert abs(_ratio(out["job_steps"][layout][1], ref) - 1.0) < 1e-3
