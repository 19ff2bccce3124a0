"""Port parity of ``utils/draw.py``: the line sets bit-equal to the JAX
package's, the scan-geometry composition within 1e-6 (the port's rays and
poses, float32 from a float64 pose), and the PNGs written headlessly.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu import geometry as JG  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.utils import draw as jd  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch import geometry as TG  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.utils import draw as td  # noqa: E402

GEO_KW = dict(DSD=1.5, DSO=1.0, nDetector=(8, 6), dDetector=(0.01, 0.01),
              nVoxel=(8, 8, 8), dVoxel=(0.01, 0.01, 0.01))


def _same(a, b):
    for f in ("points", "lines", "colors"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _line_sets(mod):
    rng = np.random.default_rng(0)
    pose = np.eye(4)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.normal(size=3)
    return {
        "rays": mod.plot_rays(rng.normal(size=(5, 4, 3)), rng.normal(size=(5, 4, 3)), 1.7),
        "pose": mod.plot_camera_pose(pose),
        "cube": mod.plot_cube(rng.normal(size=3), rng.uniform(0.5, 2.0, 3)),
    }


@pytest.mark.parametrize("which", ["rays", "pose", "cube", "sum"])
def test_line_sets_bit_equal(which):
    j, t = _line_sets(jd), _line_sets(td)
    if which == "sum":
        _same(t["cube"] + t["pose"] + t["rays"], j["cube"] + j["pose"] + j["rays"])
        np.testing.assert_array_equal((t["cube"] + t["rays"]).segments(),
                                      (j["cube"] + j["rays"]).segments())
    else:
        _same(t[which], j[which])


@pytest.mark.parametrize("mode,tilt", [("cone", 0.0), ("parallel", 29.0)])
def test_plot_scan_geometry_matches_jax(mode, tilt, monkeypatch):
    captured = {}
    for name, mod in (("jax", jd), ("torch", td)):
        monkeypatch.setattr(mod, "draw_scene",
                            lambda sets, path=None, n=name: captured.setdefault(n, sets))
    angles = [0.0, 1.1, np.pi / 2]
    jd.plot_scan_geometry(JG.ConeGeometry(mode=mode, tilt_angle=tilt, **GEO_KW), angles)
    td.plot_scan_geometry(TG.ConeGeometry(mode=mode, tilt_angle=tilt, **GEO_KW), angles)
    j, t = captured["jax"], captured["torch"]
    assert len(j) == len(t) == 1 + 2 * len(angles)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.points, b.points, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a.lines, b.lines)
        np.testing.assert_array_equal(a.colors, b.colors)


def test_draw_scene_writes_png(tmp_path):
    geo = TG.ConeGeometry(mode="cone", **GEO_KW)
    out = tmp_path / "scene.png"
    fig = td.plot_scan_geometry(geo, angles=[0.0, np.pi / 2], path=str(out))
    plt.close(fig)
    assert out.exists() and out.stat().st_size > 0
    fig = td.draw_scene([td.plot_cube(np.zeros(3), np.ones(3))], path=str(tmp_path / "c.png"))
    plt.close(fig)
    assert (tmp_path / "c.png").stat().st_size > 0


def test_sampling_debug_plots(tmp_path):
    out = td.manual_vmap(lambda x: x * 2, np.arange(6).reshape(3, 2))
    np.testing.assert_array_equal(out, jd.manual_vmap(lambda x: x * 2,
                                                      np.arange(6).reshape(3, 2)))
    rng = np.random.default_rng(0)
    mask = (rng.random((32, 32)) > 0.3).astype(np.float32)
    coords = rng.integers(0, 32, (50, 2))
    mvals = mask[coords[:, 0], coords[:, 1]]
    p1 = td.visualize_sampled_points(mask, coords, mvals, 7, outdir=str(tmp_path))
    p2 = td.visualize_after_mask(mask, coords, mvals, 7, outdir=str(tmp_path))
    assert os.path.exists(p1) and os.path.exists(p2)
