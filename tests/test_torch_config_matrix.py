"""The configuration classes the repo ships, in the port against the JAX
package, on the CPU at small sizes.

- Every ``configs/*.yaml`` resolves (``load_config`` + ``with_defaults``)
  to the same dict in both packages.
- The abdomen, foot and jaw variants of the config-matrix scripts
  (``n_samples`` cut to an eighth; sigmoid, tanh and no activation; the
  jaw's beam mask from a 2-D ``full_proj``) and the TV-D loss of
  ``configs/chest_phantom_tvd.yaml``: the port's ``make_epoch_fn`` against
  JAX's over a 3-step epoch fed JAX's draws, as in
  ``tests/test_torch_epoch.py`` and with its tolerances: each loss within
  rtol 1e-5, parameters within 1e-3 * lr * T where every step's gradient
  exceeds 1e-6 and 2 * lr * T elsewhere (T = 3).
- The data functions of the port's scripts (the smoothed chest phantom, the
  view sweep, the config-matrix smoke and converge scans) on a 16^3 scan
  against the JAX package's ``generate``, ``scipy.ndimage.gaussian_filter``
  and ``project_angles`` called directly: images, angles and beams
  bit-equal, projections within 1e-5 of the largest value (the projector's
  tolerance in ``tests/test_torch_data_gen.py``).
- The view sweep's reprojection rule, the converge script's data paths
  (the bundled scan read, never written), and the variants, scans, beams
  and configs against the JAX matrix scripts, read from their source
  (``ast``): those scripts run their work at import.
- ``scripts/compare_hash_variants_torch.py`` end to end, 2 epochs on a 16^3
  scan.
"""

import ast
import functools
import importlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from scipy.ndimage import gaussian_filter  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu import config as jconfig  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu import geometry as JG  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.data import dataset as jds  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.data import projector as jproj  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.train import trainer as jtrainer  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch import config as tconfig  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.data import dataset as tds  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.models import params_from_jax  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.train import optim as toptim  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as ttrainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
smoke = importlib.import_module("config_matrix_smoke_torch")
converge = importlib.import_module("config_matrix_converge_torch")
smooth = importlib.import_module("make_smooth_phantom_torch")
sweep = importlib.import_module("make_view_sweep_data_torch")
hashcmp = importlib.import_module("compare_hash_variants_torch")
# the package exports the function ``generate``, which hides the module
jgen = importlib.import_module("neuralvolumetricreconstructionformedicalimages_tpu.data.generate")

CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.yaml"))
SMOKE = str(REPO / "data" / "smoke.pickle")
STEPS, N_RAYS, LR = 3, 64, 1e-2
# 8 mm voxels keep the packages' ulp-apart rays on the same side of the
# phantoms' edges (tests/test_torch_data_gen.py); 17 detector rows
SCAN = {"nVoxel": [16, 16, 16], "dVoxel": [8.0, 8.0, 8.0], "nDetector": [16, 17],
        "dDetector": [12.0, 12.0], "numTrain": 3, "numVal": 2, "mode": "cone",
        "totalAngle": 180}


def test_every_config_is_listed():
    assert len(CONFIGS) == 18


@pytest.mark.parametrize("name", CONFIGS)
def test_config_resolves_alike(name, monkeypatch):
    """``inherit_from`` resolves against the working directory too."""
    monkeypatch.chdir(REPO)
    path = os.path.join("configs", name)
    assert (tconfig.with_defaults(tconfig.load_config(path))
            == jconfig.with_defaults(jconfig.load_config(path)))


# ---- the variants through the epoch function, fed JAX's draws ----

def _epoch_variants():
    tvd = jconfig.load_config(str(REPO / "configs" / "chest_phantom_tvd.yaml"))
    out = {name: dict(n_samples=v["n_samples"] // 8, last_activation=v["last_activation"],
                      mask=v["mask"], loss="mse")
           for name, v in converge.VARIANTS.items()}
    out["tvd"] = dict(n_samples=32, last_activation="sigmoid", mask=False,
                      loss=tvd["train"]["loss"])
    return out


EPOCH_VARIANTS = _epoch_variants()


def _cfg(v):
    return {
        "exp": {"expname": "t", "expdir": ".", "datadir": SMOKE},
        "network": {"net_type": "mlp", "num_layers": 4, "hidden_dim": 16,
                    "skips": [2], "out_dim": 1, "last_activation": v["last_activation"],
                    "bound": 0.3},
        "encoder": {"encoding": "hashgrid", "input_dim": 3, "num_levels": 3,
                    "level_dim": 2, "base_resolution": 8, "log2_hashmap_size": 14,
                    "forward": "sorted", "table_dtype": "bfloat16", "pack_sort": True},
        "render": {"n_samples": v["n_samples"], "n_fine": 0, "perturb": True,
                   "raw_noise_std": 0.0, "netchunk": 4096},
        "train": {"epoch": 0, "n_batch": 1, "n_rays": N_RAYS, "lrate": LR,
                  "lrate_gamma": 0.1, "lrate_step": 10, "resume": False,
                  "loss": v["loss"]},
        "log": {"i_eval": 0, "i_save": 0},
    }


def _jax_draws(key, view_order, counts, n_samples):
    """The pool draws and the stratified jitter JAX's epoch function draws
    from ``key`` (one view a step; ``tests/test_torch_epoch.py``)."""
    r, t_rand = [], []
    for i, k in enumerate(jax.random.split(key, view_order.shape[0])):
        k_pix, k_render = jax.random.split(k)
        (pk,) = jax.random.split(k_pix, 1)
        r.append([np.asarray(jax.random.randint(pk, (N_RAYS,), 0, counts[view_order[i, 0]]))])
        t_rand.append(np.asarray(jax.random.uniform(
            jax.random.split(k_render, 4)[0], (N_RAYS, n_samples), jnp.float32)))
    return {"r": np.asarray(r), "t_rand": np.asarray(t_rand)}


@pytest.mark.parametrize("name", sorted(EPOCH_VARIANTS))
def test_variant_epoch_matches_jax(name):
    v = EPOCH_VARIANTS[name]
    data = tds.load_pickle(SMOKE)
    if v["mask"]:     # the jaw's beam: one 2-D full_proj for every view
        data["full_proj"] = smoke.beam_full_proj(data)
    cfg = _cfg(v)
    cfg_j, cfg_t = jconfig.with_defaults(cfg), tconfig.with_defaults(cfg)
    jd = jds.make_dataset(data, "train", n_rays=N_RAYS)
    td = tds.make_dataset(data, "train", n_rays=N_RAYS)
    masked = bool(float(td.mask.min()) < 1.0)          # the trainer's rule
    assert masked == v["mask"]
    np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
    ja, ta = jd.arrays(), td.arrays()
    spe = td.n_views
    view_order = np.arange(STEPS).reshape(STEPS, 1)

    spec = jtrainer.build_model(cfg_j)
    state = jtrainer.init_state(cfg_j, spec, spe, jax.random.key(0))
    table = state["params"]["coarse"]["encoder"]["table"]
    state["params"]["coarse"]["encoder"]["table"] = jnp.asarray(
        0.1 * np.random.default_rng(0).normal(size=table.shape).astype(np.float32))
    params0 = jax.tree.map(np.asarray, state["params"]["coarse"])
    epoch_j = jtrainer.make_epoch_fn(cfg_j, spec, spe, N_RAYS, 1, masked,
                                     geo=jd.geo, near=jd.near, far=jd.far)
    key = jax.random.key(5)
    state, jlosses = epoch_j(state, ja, jnp.asarray(view_order), key)
    jparams = jax.tree.map(np.asarray, state["params"]["coarse"])

    field = ttrainer.build_model(cfg_t)
    assert field.last_activation == v["last_activation"]
    field.load_state_dict(params_from_jax(params0))
    opt = toptim.make_optimizer(cfg_t, field.parameters())
    epoch_t = ttrainer.make_epoch_fn(
        cfg_t, field, opt, spe, n_rays=N_RAYS, n_batch=1, use_mask=masked,
        generator=None, geo=td.geo, near=td.near, far=td.far)
    grads = {n: [] for n, _ in field.named_parameters()}
    for n, p in field.named_parameters():
        p.register_hook(functools.partial(lambda k, g: grads[k].append(g.clone()), n))
    draws = _jax_draws(key, view_order, np.asarray(jd.pool_counts), v["n_samples"])
    tlosses = epoch_t(ta, view_order, 0, draws=draws)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=1e-5)

    want = params_from_jax(jparams)
    for n, p in field.named_parameters():
        g = torch.stack(grads[n])
        big = (g.abs() > 1e-6).all(0)
        d = (p.detach() - want[n]).abs()
        assert d.max() <= 2 * LR * STEPS, n
        if big.any():
            assert d[big].max() <= 1e-3 * LR * STEPS, (n, float(d[big].max()))


# ---- the scripts' data functions against the JAX package's ----

def _close_projections(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def small_base():
    """A 16^3 Shepp-Logan scan (seed 7) of the JAX package's generator."""
    return jgen.generate(SCAN, phantom="shepp_logan", seed=7)


def _jax_views(img, data, angles):
    return np.asarray(jproj.project_angles(jnp.asarray(img), JG.ConeGeometry.from_dict(data),
                                           np.asarray(angles, np.float32), 0))


def test_smooth_phantom_matches_jax(small_base):
    out = smooth.smooth_phantom(small_base, device="cpu")
    img = gaussian_filter(np.asarray(small_base["image"], np.float32), 1.0)
    np.testing.assert_array_equal(out["image"], img)
    assert out["image"].dtype == np.float32
    for split in ("train", "val"):
        assert out[split]["angles"] is small_base[split]["angles"]
        _close_projections(out[split]["projections"],
                           _jax_views(img, small_base, small_base[split]["angles"]))


@pytest.mark.parametrize("n_views", [5, 12])
def test_view_sweep_matches_jax(small_base, n_views):
    out = sweep.view_sweep(small_base, n_views, device="cpu")
    total = small_base["totalAngle"] / 180.0 * np.pi
    start = small_base["startAngle"] / 180.0 * np.pi
    angles = (np.linspace(0, total, n_views + 1)[:-1] + start).astype(np.float32)
    assert out["train"]["angles"].dtype == np.float64
    np.testing.assert_array_equal(out["train"]["angles"], angles.astype(np.float64))
    assert out["numTrain"] == n_views and out["val"] is small_base["val"]
    assert out["image"] is small_base["image"]
    _close_projections(out["train"]["projections"],
                       _jax_views(small_base["image"], small_base, angles))


@pytest.mark.parametrize("case", ["known_pixels", "too_many", "other_view", "too_far"])
def test_reprojection_rule(small_base, case):
    """The rule of ``make_view_sweep_data_torch.check_reprojection`` (and
    of ``chip_smoke.py`` e1) on 40 stored views: up to 24 pixels over 1e-6,
    all in views 16 and 34, each within one boundary-voxel sample."""
    base = jgen.generate(dict(SCAN, numTrain=40), phantom="shepp_logan", seed=7)
    stored = base["train"]["projections"]
    geo = JG.ConeGeometry.from_dict(base)
    near, far = JG.get_near_far(geo)
    sample = float(base["image"].max()) * (far - near) / (2 * max(geo.nVoxel) - 1)
    got = stored.copy()
    views, n_px, by = {"known_pixels": ([16, 34], 12, 0.5), "too_many": ([16, 34], 13, 0.5),
                       "other_view": ([16, 5], 12, 0.5), "too_far": ([16, 34], 12, 3.0)}[case]
    for v in views:
        got[v].reshape(-1)[:n_px] += by * sample
    if case == "known_pixels":
        res = sweep.check_reprojection(base, got)
        assert res["pixels_over_1e6"] == 24 and res["views_over_1e6"] == [16, 34]
    else:
        with pytest.raises(AssertionError, match="beyond the known boundary samples"):
            sweep.check_reprojection(base, got)


def _jax_script(script):
    """The syntax tree of ``scripts/config_matrix_<script>.py``, which runs
    its work at import and so is read, not imported."""
    return ast.parse((REPO / "scripts" / f"config_matrix_{script}.py").read_text())


def _jax_constant(script, target):
    """The value of the JAX script's top-level ``target = ...`` (built of
    literals and ``dict(...)``)."""
    for node in _jax_script(script).body:
        if isinstance(node, ast.Assign) and [t.id for t in node.targets] == [target]:
            return eval(compile(ast.Expression(node.value), script, "eval"),
                        {"__builtins__": {}, "dict": dict})
    raise LookupError(f"{target} not in config_matrix_{script}.py")


def _jax_beam(script, scan):
    """The JAX script's ``full_proj``: the body of ``make_data``'s ``if
    masked:`` block, run on ``scan``."""
    make_data = next(n for n in ast.walk(_jax_script(script))
                     if isinstance(n, ast.FunctionDef) and n.name == "make_data")
    block = next(n for n in ast.walk(make_data) if isinstance(n, ast.If)
                 and isinstance(n.test, ast.Name) and n.test.id == "masked")
    ns = {"np": np, "SCAN": scan, "data": {}}
    exec(compile(ast.Module(block.body, type_ignores=[]), script, "exec"), ns)
    return ns["data"]["full_proj"]


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_smoke_data_matches_jax(masked, small_base):
    got = smoke.smoke_data(masked, device="cpu", scan=SCAN)
    np.testing.assert_array_equal(got["image"], small_base["image"])
    for split in ("train", "val"):
        np.testing.assert_array_equal(got[split]["angles"], small_base[split]["angles"])
        _close_projections(got[split]["projections"], small_base[split]["projections"])
    if masked:
        assert got["full_proj"].shape == (17, 16)
        np.testing.assert_array_equal(got["full_proj"], _jax_beam("smoke", SCAN))
    else:
        assert "full_proj" not in got


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_converge_data_matches_jax(masked, small_base):
    got = converge.smooth_data(masked, device="cpu", scan=SCAN)
    img = gaussian_filter(np.asarray(small_base["image"], np.float32), 1.0)
    np.testing.assert_array_equal(got["image"], img)
    for split in ("train", "val"):
        np.testing.assert_array_equal(got[split]["angles"], small_base[split]["angles"])
        _close_projections(got[split]["projections"],
                           _jax_views(img, small_base, small_base[split]["angles"]))
    assert ("full_proj" in got) == masked
    if masked:
        np.testing.assert_array_equal(got["full_proj"], _jax_beam("converge", SCAN))


def test_converge_reads_bundled_scans_and_never_writes_them(tmp_path, monkeypatch):
    made = []
    monkeypatch.setattr(converge, "smooth_data",
                        lambda masked, device=None: made.append(masked) or {"m": masked})
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "foot_smooth.pickle").write_bytes(b"bundled")
    assert converge.make_data("foot", "cpu") == "data/foot_smooth.pickle"
    assert converge.make_data("jaw", "cpu") == "data/jaw_smooth_torch.pickle"
    assert made == [True]                      # the jaw's scan, with its beam
    assert (tmp_path / "data" / "foot_smooth.pickle").read_bytes() == b"bundled"
    assert not (tmp_path / "data" / "jaw_smooth.pickle").exists()
    assert tds.load_pickle("data/jaw_smooth_torch.pickle") == {"m": True}
    for name in converge.VARIANTS:    # the repository holds every bundled scan
        assert (REPO / "data" / f"{name}_smooth.pickle").exists()


def _jax_script_cfg(script, name, path):
    """The JAX script's config of variant ``name`` on ``path``: its
    statements that build ``cfg``, run in order on its own ``VARIANTS``."""
    stmts = sorted((n for n in ast.walk(_jax_script(script))
                    if isinstance(n, (ast.Assign, ast.Expr))
                    and ast.unparse(n).startswith("cfg")), key=lambda n: n.lineno)
    ns = {"load_config": jconfig.load_config, "with_defaults": jconfig.with_defaults,
          "name": name, "v": _jax_constant(script, "VARIANTS")[name], "path": path}
    exec(compile(ast.Module(stmts, type_ignores=[]), script, "exec"), ns)
    return ns["cfg"]


@pytest.mark.parametrize("script", ["smoke", "converge"])
def test_variants_and_scan_match_jax_scripts(script):
    port = {"smoke": smoke, "converge": converge}[script]
    assert port.VARIANTS == _jax_constant(script, "VARIANTS")
    assert port.SCAN == _jax_constant(script, "SCAN")


@pytest.mark.parametrize("script", ["smoke", "converge"])
@pytest.mark.parametrize("name", ["abdomen", "foot", "jaw"])
def test_variant_configs_match_jax_scripts(name, script, monkeypatch):
    monkeypatch.chdir(REPO)
    path = f"data/{name}_smooth.pickle"
    if script == "converge":
        got = converge.variant_cfg(name, path)
    else:
        got = smoke.variant_cfg(smoke.VARIANTS[name], f"{name}_smoke", path)
    want = _jax_script_cfg(script, name, path)
    assert got["exp"].pop("expname").startswith(name)
    assert want["exp"].pop("expname").startswith(name)
    assert got == want


def test_compare_hash_variants_end_to_end(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)      # main() moves to the repository root
    monkeypatch.setattr(hashcmp, "SCAN", dict(
        hashcmp.SCAN, nVoxel=[16, 16, 16], dVoxel=[8.0, 8.0, 8.0], nDetector=[16, 16],
        dDetector=[16.0, 16.0], numTrain=4, numVal=2))
    monkeypatch.setattr(hashcmp, "run", functools.partial(hashcmp.run, scan=hashcmp.SCAN))
    out = tmp_path / "hash_quality.md"
    assert hashcmp.main(["--epochs", "2", "--out", str(out), "--device", "cpu"]) == 0
    rows = [ln for ln in out.read_text().splitlines()
            if ln.startswith("| ") and not ln.startswith("| variant")]
    assert [r.split(" | ")[0][2:] for r in rows] == list(hashcmp.VARIANTS)
    for r in rows:
        psnr, ssim, loss = (float(x) for x in r.split(" | ")[1:4])
        assert np.isfinite([psnr, ssim, loss]).all() and psnr > 0
