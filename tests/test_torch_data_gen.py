"""Port parity of the data side: phantoms, the forward projector, the
generator, the real-data formatter and the pickle schema, against the JAX
package on the same inputs (made from a seed with numpy), on the CPU.

Tolerances, with their reasons: the phantoms, the angles, the volumes,
the CT noise and the formatter are NumPy in both packages (bit-equal);
``trilinear_sample`` repeats JAX's operations in its order (rtol 1e-6,
atol 1e-7); a projection sums a few hundred f32 samples in another order
(atol 1e-5 of the largest value); the SciPy parallel-beam path against
JAX's copy, given the same rays, differs only in the norm of the shared
direction (rtol 1e-6), and against the sampled projector to interpolation
accuracy (atol 0.02 of the largest value, as the JAX package's own test).
"""

import importlib
import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu import geometry as JG  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.data import dataset as jds  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.data import format_real as jfmt  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.data import phantoms as jph  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.data import projector as jproj  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch import data as tdata  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch import geometry as TG  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.data import dataset as tds  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.data import format_real as tfmt  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.data import phantoms as tph  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.data import projector as tproj  # noqa: E402

# the packages export the function ``generate``, which hides the module
jgen = importlib.import_module("neuralvolumetricreconstructionformedicalimages_tpu.data.generate")
tgen = importlib.import_module("neuralvolumetricreconstructionformedicalimages_torch.data.generate")

GEO_KW = dict(DSD=1.5, DSO=1.0, nDetector=(16, 17), dDetector=(0.01, 0.01),
              nVoxel=(16, 16, 16), dVoxel=(0.008, 0.008, 0.008))
# a tiny scan in the generator's units (mm), 17 detector rows (prime).
# Voxels of 8 mm: the packages' rays differ by an ulp (~1.2e-7 m at 1 m
# from the axis), which moves a sample by 1.5e-5 of a voxel here, so the
# phantoms' binary edges stay within the 1e-5 tolerance (at 1 mm they
# would move samples by 1.2e-4 of a voxel).
SCAN = {"nVoxel": [16, 16, 16], "dVoxel": [8.0, 8.0, 8.0], "nDetector": [16, 17],
        "dDetector": [12.0, 12.0], "numTrain": 3, "numVal": 2, "DSD": 1500.0,
        "DSO": 1000.0}


def _geos(mode, tilt):
    return (JG.ConeGeometry(mode=mode, tilt_angle=tilt, **GEO_KW),
            TG.ConeGeometry(mode=mode, tilt_angle=tilt, **GEO_KW))


def _assert_same_tree(a, b, path="data"):
    """Equal keys, equal scalars and lists, bit-equal arrays."""
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


# ---------------------------------------------------------------- phantoms

@pytest.mark.parametrize("size", [(16, 16, 16), (24, 20, 9)])
@pytest.mark.parametrize("name", sorted(jph.PHANTOMS))
def test_phantoms_bit_equal(name, size):
    assert sorted(tph.PHANTOMS) == sorted(jph.PHANTOMS)
    want = jph.get_phantom(name, size)
    got = tph.get_phantom(name, size)
    assert got.dtype == want.dtype and got.shape == tuple(size)
    assert np.array_equal(got, want)


def test_unknown_phantom_raises():
    with pytest.raises(KeyError, match="Unknown phantom"):
        tph.get_phantom("nope", (4, 4, 4))


# --------------------------------------------------------------- projector

@pytest.mark.parametrize("where", ["inside", "outside", "boundary_band"])
def test_trilinear_sample_matches_jax(where):
    rng = np.random.default_rng(1)
    jg, tg = _geos("cone", 0.0)
    vol = rng.random(tg.nVoxel).astype(np.float32)
    n = np.asarray(tg.nVoxel, np.float64)
    d = np.asarray(tg.dVoxel, np.float64)
    half = n * d / 2 - d / 2
    if where == "inside":
        f = rng.uniform(0.0, 1.0, (4000, 3)) * (n - 1)
    elif where == "outside":
        f = rng.uniform(-3.0, 3.0, (4000, 3)) * (n - 1)
    else:   # voxel coordinates within a few 1e-4 of the first/last center
        f = rng.uniform(0.0, 1.0, (4000, 3)) * (n - 1)
        axis = rng.integers(0, 3, 4000)
        edge = np.where(rng.random(4000) < 0.5, 0.0, n[axis] - 1)
        f[np.arange(4000), axis] = edge + rng.uniform(-3e-4, 3e-4, 4000)
    pts = (f * d - half).astype(np.float32)
    want = np.asarray(jproj.trilinear_sample(jnp.asarray(vol), jnp.asarray(pts), jg))
    got = tproj.trilinear_sample(torch.as_tensor(vol), torch.as_tensor(pts), tg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if where == "outside":
        assert (want == 0).any() and (want != 0).any()


@pytest.mark.parametrize("mode,tilt", [("cone", 0.0), ("parallel", 0.0),
                                       ("parallel", 29.0)])
def test_project_angles_matches_jax(mode, tilt):
    rng = np.random.default_rng(2)
    jg, tg = _geos(mode, tilt)
    vol = rng.random(tg.nVoxel).astype(np.float32)
    angles = np.array([0.1, 1.3, 4.0], np.float32)
    want = np.asarray(jproj.project_angles(jnp.asarray(vol), jg, angles, 0))
    got = tproj.project_angles(vol, tg, angles, device="cpu")
    assert got.shape == (3, 17, 16) and got.dtype == torch.float32
    assert float(np.abs(want).max()) > 0.01
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_project_angles_row_tiles(monkeypatch):
    """Several row tiles with a padded last one (17 rows, 5-row tiles)
    give JAX's one-tile result, on the volume's device by default."""
    rng = np.random.default_rng(3)
    jg, tg = _geos("parallel", 29.0)
    vol = torch.as_tensor(rng.random(tg.nVoxel).astype(np.float32))
    angles = np.array([0.7], np.float32)
    monkeypatch.setattr(tproj, "_TILE_BYTES", 16 * 32 * 12 * 5)   # 5 rows a tile
    tiled = tproj.project_angles(vol, tg, angles, 32)
    assert tiled.device == vol.device
    want = np.asarray(jproj.project_angles(jnp.asarray(vol.numpy()), jg, angles, 32))
    np.testing.assert_allclose(tiled.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_project_angles_without_card_raises():
    """No explicit device and a NumPy volume mean the card; without one
    the projector raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default runs there")
    _, tg = _geos("cone", 0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproj.project_angles(np.zeros(tg.nVoxel, np.float32), tg, [0.0], 8)


@pytest.mark.parametrize("view", [0, 16, 34])
def test_stored_chest_views_against_both_projectors(view):
    """``data/chest_phantom.pickle`` at full size (128^3, 256^2 x 256
    samples): the port reprojects the JAX projector's view to 2e-6 (ray
    origins and directions an ulp apart move samples on the phantom's
    steep edges).  The stored views 16 and 34 were made by an earlier JAX
    projector: today's JAX projector differs from each at 12 pixels, by up
    to 5.81e-4 (under one boundary-voxel sample, 7.5e-4: samples within an
    ulp of the in-volume band's edge), and the port follows today's."""
    data = tds.load_pickle(os.path.join(os.path.dirname(__file__), "..", "data",
                                        "chest_phantom.pickle"))
    jg, tg = JG.ConeGeometry.from_dict(data), TG.ConeGeometry.from_dict(data)
    angle = np.asarray(data["train"]["angles"], np.float32)[view:view + 1]
    want = np.asarray(jproj.project_angles(jnp.asarray(data["image"]), jg, angle))[0]
    got = tproj.project_angles(data["image"], tg, angle, device="cpu").numpy()[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    stored_err = np.abs(want - data["train"]["projections"][view])
    if view in (16, 34):
        bad = np.nonzero(stored_err > 1e-6)
        assert len(bad[0]) == 12
        assert 5.8e-4 < stored_err.max() < 5.82e-4
    else:
        assert stored_err.max() <= 1e-6


def test_parallel_cpu_projector_matches_jax(monkeypatch):
    """The SciPy path against JAX's copy and against the sampled projector
    (the JAX package's ``test_parallel_cpu_projector_matches_jax``).

    The two packages' rays differ by an ulp (the port takes the pose in
    float64), which moves samples across the ball's binary edge by ~1e-4
    of the largest value; given JAX's rays, the copy agrees to rtol 1e-6.
    """
    kw = dict(DSD=1.5, DSO=1.0, nDetector=(48, 40), dDetector=(0.01, 0.01),
              nVoxel=(64, 64, 64), dVoxel=(0.004, 0.004, 0.004),
              mode="parallel", tilt_angle=29.0)
    jg, tg = JG.ConeGeometry(**kw), TG.ConeGeometry(**kw)
    vol = tph.get_phantom("ball", (64, 64, 64))
    angles = np.linspace(0.1, 3.0, 3).astype(np.float32)
    want = jproj.project_angles_parallel_cpu(vol, jg, angles, 160)
    got = tproj.project_angles_parallel_cpu(vol, tg, angles, 160)
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * top)
    sampled = tproj.project_angles(vol, tg, angles, 160, device="cpu").numpy()
    assert np.abs(sampled).max() > 0.01
    np.testing.assert_allclose(got, sampled, atol=0.02 * float(np.abs(sampled).max()))

    def jax_rays(geo, angle, device="cpu"):
        return tuple(torch.tensor(np.asarray(x)) for x in JG.rays_for_angle(jg, angle))
    monkeypatch.setattr(tproj.G, "rays_for_angle", jax_rays)
    same_rays = tproj.project_angles_parallel_cpu(vol, tg, angles, 160)
    np.testing.assert_allclose(same_rays, want, rtol=1e-6, atol=0)


def test_parallel_cpu_projector_empty_angles():
    _, tg = _geos("parallel", 29.0)
    out = tproj.project_angles_parallel_cpu(np.ones(tg.nVoxel, np.float32), tg, [])
    assert out.shape == (0, 17, 16) and out.dtype == np.float32


# --------------------------------------------------------------- generator

@pytest.fixture
def mat_path(tmp_path):
    import scipy.io

    img = np.random.default_rng(4).normal(0.0, 300.0, (20, 18, 12)).astype(np.float32)
    path = tmp_path / "img.mat"
    scipy.io.savemat(str(path), {"img": img})
    return str(path)


def _jax_projections_for_port(monkeypatch):
    """Route the port generator's projections through JAX's projector, so
    the noise is drawn from bit-equal clean projections."""
    def project(vol, geo, angles, n_samples=0, device=None):
        jg = JG.ConeGeometry(**{f: getattr(geo, f) for f in (
            "DSD", "DSO", "nDetector", "dDetector", "nVoxel", "dVoxel", "offOrigin",
            "offDetector", "accuracy", "mode", "tilt_angle")})
        out = jproj.project_angles(jnp.asarray(vol), jg, angles, n_samples)
        return torch.tensor(np.asarray(out))
    monkeypatch.setattr(tgen, "project_angles", project)


@pytest.mark.parametrize("noise", [0, 5], ids=["clean", "noise"])
@pytest.mark.parametrize("source", ["phantom", "mat"])
def test_generate_matches_jax(source, noise, mat_path, monkeypatch):
    scan = dict(SCAN, noise=noise, randomAngle=source == "mat", totalAngle=360)
    if source == "mat":
        kw = dict(mat_path=mat_path)
        scan.update(convert=True, rescale_slope=1.0, rescale_intercept=-1000.0)
    else:
        kw = dict(phantom="shepp_logan")
    want = jgen.generate(scan, seed=3, **kw)
    if noise:
        _jax_projections_for_port(monkeypatch)
    got = tgen.generate(scan, seed=3, device="cpu", **kw)
    for split in ("train", "val"):
        a, b = want[split]["projections"], got[split]["projections"]
        assert b.dtype == np.float32 and b.shape == a.shape
        if noise:   # the same clean projections: the noise is bit-equal
            np.testing.assert_array_equal(b, a)
        else:
            assert np.abs(a).max() > 0
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * float(np.abs(a).max()))
        got[split]["projections"] = a
    _assert_same_tree(want, got)


def test_add_ct_noise_bit_equal():
    p = np.random.default_rng(5).uniform(0.0, 3.0, (3, 17, 16)).astype(np.float32)
    for args in [(1e5, (0.0, 10.0), 0), (1e4, (0.0, 3.0), 7)]:
        np.testing.assert_array_equal(tgen.add_ct_noise(p, *args),
                                      jgen.add_ct_noise(p, *args))


def test_generate_cli(tmp_path):
    import yaml

    cfg = tmp_path / "scan.yaml"
    cfg.write_text(yaml.safe_dump(dict(SCAN, mode="parallel", tilt_angle=29,
                                       totalAngle=360)))
    tgen.main(["--phantom", "lamino_chip", "--config", str(cfg), "--outputFolder",
               str(tmp_path), "--outputName", "chip", "--device", "cpu"])
    data = tds.load_pickle(str(tmp_path / "chip.pickle"))
    assert data["train"]["projections"].shape == (3, 17, 16)
    assert data["val"]["projections"].shape == (2, 17, 16)
    assert data["mode"] == "parallel" and data["tilt_angle"] == 29
    np.testing.assert_array_equal(data["image"], tph.get_phantom("lamino_chip", (16, 16, 16)))


# --------------------------------------------------------------- formatter

@pytest.mark.parametrize("k,image", [(1, False), (-1, True)])
def test_format_real_data_bit_equal(k, image):
    rng = np.random.default_rng(6)
    proj = (rng.normal(size=(3, 8, 6)) + 1j * rng.normal(size=(3, 8, 6))).astype(np.complex64)
    angles = np.linspace(0.0, 300.0, 3)
    img = rng.random((8, 8, 5)).astype(np.float32) if image else None
    kw = dict(tilt_angle=21.0, n_slices=5, rot90_k=k, image=img)
    _assert_same_tree(jfmt.format_real_data(proj, angles, **kw),
                      tfmt.format_real_data(proj, angles, **kw))


def test_format_real_cli(tmp_path):
    rng = np.random.default_rng(7)
    proj = np.exp(1j * rng.random((2, 6, 4))).astype(np.complex64)
    np.save(tmp_path / "p.npy", proj)
    np.save(tmp_path / "a.npy", np.array([0.0, 90.0]))
    out = tmp_path / "s.pickle"
    tfmt.main(["--projections", str(tmp_path / "p.npy"), "--angles",
               str(tmp_path / "a.npy"), "--output", str(out), "--slices", "3"])
    _assert_same_tree(tds.load_pickle(str(out)),
                      jfmt.format_real_data(proj, np.array([0.0, 90.0]), n_slices=3))


# ---------------------------------------------------------- pickle schema

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_pickle_schema_both_directions(writer, tmp_path):
    """A pickle written by either package loads in the other's
    ``load_pickle`` and builds a dataset there."""
    path = str(tmp_path / "scan.pickle")
    if writer == "jax":
        data = jgen.generate(SCAN, phantom="ball", seed=1)
        jgen.save(data, path)
        loaded = tds.load_pickle(path)
        ds = tds.make_dataset(loaded, "train", n_rays=8, device="cpu")
        assert tuple(ds.projs.shape) == (3, 17, 16)
    else:
        data = tgen.generate(SCAN, phantom="ball", seed=1, device="cpu")
        tgen.save(data, path)
        loaded = jds.load_pickle(path)
        ds = jds.make_dataset(loaded, "train", n_rays=8)
        assert tuple(ds.projs.shape) == (3, 17, 16)
    with open(path, "rb") as f:
        _assert_same_tree(data, pickle.load(f))
    other = tgen.generate(SCAN, phantom="ball", seed=1, device="cpu") if writer == "jax" \
        else jgen.generate(SCAN, phantom="ball", seed=1)
    for split in ("train", "val"):
        other[split]["projections"] = loaded[split]["projections"]
    _assert_same_tree(loaded, other)


def test_data_package_exports():
    for name in ("ProjectionDataset", "load_dataset", "load_pickle", "make_dataset",
                 "project_angles", "trilinear_sample", "PHANTOMS", "get_phantom",
                 "add_ct_noise", "generate", "format_real_data"):
        assert hasattr(tdata, name), name
    assert os.path.basename(tgen.__file__) == "generate.py"
