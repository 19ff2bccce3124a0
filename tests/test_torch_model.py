"""Port parity of the field, renderer, sampling, integration, geometry and
dataset layers against the JAX package, on the same numpy inputs (random
draws made by JAX and fed to the port).

Tolerances: both sides compute in float32; the port takes the pose
products in float64, so rays agree to a few float32 ulps of their O(1 m)
magnitude (atol 2e-6); MLP outputs, depths and line integrals are sums
of a few hundred float32 terms (rtol 1e-5, atol 1e-6 unless stated);
indices, pools and masks are exact.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu import geometry as jgeo  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu import render as jrender  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.data import dataset as jds  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.models import (  # noqa: E402
    DensityFieldSpec,
    get_encoder as j_get_encoder,
)
from neuralvolumetricreconstructionformedicalimages_tpu.ops import integration as jint  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops import sampling as jsam  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch import geometry as tgeo  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch import render as trender  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.data import dataset as tds  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.models import (  # noqa: E402
    DensityField,
    get_encoder as t_get_encoder,
    params_from_jax,
)
from neuralvolumetricreconstructionformedicalimages_torch.ops import integration as tint  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import sampling as tsam  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "data", "smoke.pickle")
ENC = dict(encoding="hashgrid", num_levels=4, base_resolution=4,
           log2_hashmap_size=9)  # table size 2^9: the plain oracle in both
NET = dict(bound=0.3, num_layers=4, hidden_dim=32, skips=(2,), out_dim=1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _fields(seed=0, last_activation="sigmoid", compute_dtype="float32", **enc):
    """A JAX field and the port's, with the same (JAX-initialised) weights
    and an N(0, 0.3) hash table."""
    spec = DensityFieldSpec(encoder=j_get_encoder(**{**ENC, **enc}), **NET,
                            last_activation=last_activation,
                            compute_dtype=compute_dtype)
    params = spec.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params["encoder"]["table"] = jnp.asarray(
        0.3 * rng.normal(size=params["encoder"]["table"].shape).astype(np.float32))
    field = DensityField(t_get_encoder(**{**ENC, **enc}), **NET,
                         last_activation=last_activation,
                         compute_dtype=compute_dtype)
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return spec, params, field


@pytest.fixture(scope="module")
def smoke_data():
    return tds.load_pickle(SMOKE)


@pytest.mark.parametrize("act,cd", [("sigmoid", "float32"), ("relu", "float32"),
                                    ("tanh", "bfloat16"), ("none", "bfloat16")])
def test_density_field_matches_jax_apply(act, cd):
    spec, params, field = _fields(1, act, cd)
    x = np.random.default_rng(2).uniform(-0.35, 0.35, (300, 3)).astype(np.float32)
    j = np.asarray(spec.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        t = field(torch.as_tensor(x)).numpy()
    assert [tuple(d) for d in field.layer_dims] == [tuple(d) for d in spec.layer_dims]
    tol = 1e-5 if cd == "float32" else 2e-3  # bf16 operands round differently
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol)


def test_density_field_init_distribution():
    field = DensityField(t_get_encoder(**ENC), **NET,
                         generator=torch.Generator().manual_seed(0))
    for lin, (fan_in, _) in zip(field.layers, field.layer_dims):
        b = 1 / np.sqrt(fan_in)
        assert float(lin.weight.detach().abs().max()) <= b
        assert float(lin.bias.detach().abs().max()) <= b
    assert float(field.table.detach().abs().max()) <= 1e-4


def test_freq_encoder_matches():
    x = np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32)
    j = j_get_encoder("frequency", multires=6).apply({}, jnp.asarray(x), 0.2)
    t = t_get_encoder("frequency", multires=6).apply({}, torch.as_tensor(x), 0.2)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def _rays(smoke_data, n=48):
    ds = tds.make_dataset(smoke_data, "train")
    idx = np.random.default_rng(4).choice(ds.H * ds.W, n, replace=False)
    return ds.rays[3].reshape(-1, 8)[torch.as_tensor(idx)].numpy()


@pytest.mark.parametrize("fed", [False, True], ids=["no_perturb", "fed_draws"])
def test_render_rays_matches(smoke_data, fed):
    spec, params, field = _fields(5)
    rays = _rays(smoke_data)
    n_samples = 32
    kw = dict(n_samples=n_samples, perturb=fed)
    key = jax.random.key(9) if fed else None
    j = jrender.render_rays(jnp.asarray(rays), params, spec, key=key, **kw)
    t_rand = None
    if fed:  # the draw JAX's stratified sampler takes from its key
        k_strat = jax.random.split(key, 4)[0]
        t_rand = _t(jax.random.uniform(k_strat, (len(rays), n_samples), jnp.float32))
    with torch.no_grad():
        t = trender.render_rays(torch.as_tensor(rays), field, t_rand=t_rand, **kw)
    np.testing.assert_allclose(t["pts"].numpy(), np.asarray(j["pts"]), atol=2e-6)
    for k in ("acc", "tv_loss", "tv_density"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-5, atol=1e-6)


def test_render_fine_pass_and_eval_paths(smoke_data):
    spec, params, field = _fields(6)
    _, params_f, field_f = _fields(7)
    rays = _rays(smoke_data, 40)
    kw = dict(n_samples=24, n_fine=16, perturb=False)
    j = jrender.render_rays(jnp.asarray(rays), params, spec, params_fine=params_f,
                            spec_fine=spec, **kw)
    with torch.no_grad():
        t = trender.render_rays(torch.as_tensor(rays), field, field_fine=field_f, **kw)
    for k in ("acc0", "acc"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-5, atol=1e-6)
    # |differences| of adjacent densities amplify their f32 rounding
    np.testing.assert_allclose(t["weights0"].numpy(), np.asarray(j["weights0"]),
                               atol=5e-5)
    ji = jrender.render_image(jnp.asarray(rays), params, spec, n_samples=24, tile=16)
    ti = trender.render_image(torch.as_tensor(rays), field, n_samples=24, tile=16)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-6)
    pts = np.random.default_rng(8).uniform(-0.3, 0.3, (5, 7, 3)).astype(np.float32)
    jq = jrender.query_field(jnp.asarray(pts), params, spec, tile=8)
    tq = trender.query_field(torch.as_tensor(pts), field, tile=8)
    assert tq.shape == (5, 7, 1)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)


def test_raw2outputs_matches():
    rng = np.random.default_rng(10)
    z = np.sort(rng.uniform(0.8, 1.2, (30, 40)), axis=1).astype(np.float32)
    d = rng.normal(size=(30, 3)).astype(np.float32)
    for ch in (1, 2):
        raw = rng.uniform(0, 1, (30, 40, ch)).astype(np.float32)
        ja, jw = jint.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d))
        ta, tw = tint.raw2outputs(*map(torch.as_tensor, (raw, z, d)))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)
    noise = rng.normal(size=(30, 40)).astype(np.float32)
    ta, _ = tint.raw2outputs(*map(torch.as_tensor, (raw, z, d)), raw_noise_std=0.5,
                             noise=torch.as_tensor(noise))
    dists = np.concatenate([np.diff(z, axis=1), np.full((30, 1), 1e-10)], 1)
    want = ((raw[..., 0] + 0.5 * noise) * dists * np.linalg.norm(d, axis=-1)[:, None]).sum(1)
    np.testing.assert_allclose(ta.numpy(), want, rtol=1e-5, atol=1e-6)


def test_sampling_matches():
    rng = np.random.default_rng(11)
    near = rng.uniform(0.5, 0.7, (20, 1)).astype(np.float32)
    far = near + 0.6
    jz = jsam.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 33, False)
    tz = tsam.stratified_z_vals(torch.as_tensor(near), torch.as_tensor(far), 33, False)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-7)
    key = jax.random.key(3)
    jz = jsam.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 33, True, key)
    t_rand = _t(jax.random.uniform(key, (20, 33), jnp.float32))
    tz = tsam.stratified_z_vals(torch.as_tensor(near), torch.as_tensor(far), 33, True,
                                t_rand=t_rand)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-7)

    bins = np.sort(rng.uniform(0, 1, (20, 17)), axis=1).astype(np.float32)
    w = rng.uniform(0, 1, (20, 16)).astype(np.float32)
    j = jsam.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 12, det=True)
    t = tsam.sample_pdf(torch.as_tensor(bins), torch.as_tensor(w), 12, det=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    j = jsam.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 12, key=key)
    u = _t(jax.random.uniform(key, (20, 12), jnp.float32))
    t = tsam.sample_pdf(torch.as_tensor(bins), torch.as_tensor(w), 12, u=u)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode,tilt", [("cone", 0.0), ("parallel", 0.0),
                                       ("cone", 20.0)])
def test_geometry_rays_match(smoke_data, mode, tilt):
    data = dict(smoke_data, mode=mode, tilt_angle=tilt, offDetector=[1.5, -2.0],
                offOrigin=[3.0, -1.0, 2.0])
    jg, tg = jgeo.ConeGeometry.from_dict(data), tgeo.ConeGeometry.from_dict(data)
    assert jg == tg.__class__(**vars(tg)) or vars(jg) == vars(tg)
    angles = np.linspace(0, 2 * np.pi, 7, endpoint=False).astype(np.float32)
    np.testing.assert_allclose(tgeo.angle_to_pose(tg.DSO, angles, tilt).numpy(),
                               np.asarray(jgeo.angle_to_pose(jg.DSO, angles, tilt)),
                               atol=1e-6)
    jo, jd = jgeo.rays_for_angles(jg, angles)
    to, td = tgeo.rays_for_angles(tg, angles)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-6)
    jo1, jd1 = jgeo.rays_for_angle(jg, angles[2])
    to1, td1 = tgeo.rays_for_angle(tg, float(angles[2]))
    np.testing.assert_allclose(td1.numpy(), np.asarray(jd1), atol=2e-6)
    np.testing.assert_allclose(to1.numpy(), np.asarray(jo1), atol=2e-6)
    rows = np.array([0, 5, 63, 17], np.int32)
    cols = np.array([3, 60, 0, 33], np.int32)
    jpo, jpd = jgeo.rays_for_pixels(jg, angles[4], jnp.asarray(rows), jnp.asarray(cols))
    tpo, tpd = tgeo.rays_for_pixels(tg, torch.tensor(angles[4]), torch.as_tensor(rows),
                                    torch.as_tensor(cols))
    np.testing.assert_allclose(tpo.numpy(), np.asarray(jpo), atol=2e-6)
    np.testing.assert_allclose(tpd.numpy(), np.asarray(jpd), atol=2e-6)
    assert tgeo.get_near_far(tg) == jgeo.get_near_far(jg)
    assert tgeo.get_near_far_tilted(tg) == jgeo.get_near_far_tilted(jg)
    np.testing.assert_array_equal(tgeo.voxel_grid(tg), jgeo.voxel_grid(jg))
    np.testing.assert_array_equal(
        tgeo.pack_rays(to, td, 0.5, 1.5).numpy(),
        np.asarray(jgeo.pack_rays(jnp.asarray(to.numpy()), jnp.asarray(td.numpy()),
                                  0.5, 1.5)))


def test_make_dataset_matches(smoke_data):
    j = jds.make_dataset(smoke_data, "train", n_rays=128)
    t = tds.make_dataset(smoke_data, "train", n_rays=128)
    assert (t.near, t.far, t.ray_mode, t.n_views, t.H, t.W) == \
        (j.near, j.far, j.ray_mode, j.n_views, j.H, j.W)
    for k in ("projs", "mask", "pools", "pool_counts", "image", "voxels"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)), k)
    np.testing.assert_allclose(t.rays.numpy(), np.asarray(j.rays), atol=2e-6)
    np.testing.assert_array_equal(t.angles, j.angles)
    # a JAX pool draw fed to the port gathers the same pixels
    key = jax.random.key(12)
    jb = jds.gather_view_batch(j.arrays(), 3, key, 128)
    r = _t(jax.random.randint(key, (128,), 0, j.pool_counts[3]))
    tb = tds.gather_view_batch(t.arrays(), 3, 128, r=r)
    np.testing.assert_array_equal(tb["pix"].numpy(), np.asarray(jb["pix"]))
    for k in ("projs", "mask"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    np.testing.assert_allclose(tb["rays"].numpy(), np.asarray(jb["rays"]), atol=2e-6)
    # on-the-fly rays regenerate the precomputed ones
    f = tds.make_dataset(smoke_data, "train", n_rays=128, ray_mode="onthefly")
    fb = tds.gather_view_batch(f.arrays(), 3, 128, r=r, geo=f.geo, near=f.near,
                               far=f.far)
    np.testing.assert_allclose(fb["rays"].numpy(), tb["rays"].numpy(), atol=2e-6)
    np.testing.assert_allclose(f.view_rays(3).numpy(), t.view_rays(3).numpy(), atol=2e-6)
    # the default draw stays inside the view's valid-pixel pool
    g = torch.Generator().manual_seed(0)
    db = tds.gather_view_batch(t.arrays(), 3, 4096, generator=g)
    assert set(db["pix"].tolist()) <= set(t.pools[3, : int(t.pool_counts[3])].tolist())
