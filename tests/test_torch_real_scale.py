"""The real scan at scale and the batch sweep: the port's scripts and the
masked eval against the JAX package, on the CPU at small sizes.

- The masked eval (``Trainer.eval_step`` with ``log.eval_mask``) and the
  plain one: the JAX ``Trainer`` and the port's on one small formatted
  complex scan (7 views of 32^2, a 16 x 16 x 8 chip phantom, made by
  ``real_scale_train_r5_torch.make_data``), a 3-level 2^14 table (JAX's
  Pallas path, in interpret mode), the port started from JAX's parameters
  (``params_from_jax``).  Both render the same view with the same bf16
  gather table, so ``proj_mse`` agrees to rtol 1e-4, the PSNRs to 1e-3 dB
  and ``ssim_3d`` to 1e-6 (measured: equal, 9e-5 dB, 6e-9).
- The scripts' functions against the JAX scripts' statements, read from
  their source with ``ast`` (the JAX scripts import JAX at the top, so they
  are read, not imported): the complex scans of ``make_data`` bit-equal,
  every config equal, the real-scale smoke's geometry dict bit-equal; the
  upsampled stack of ``real_scale_train_torch`` against JAX's
  ``project_angles`` and ``scipy.ndimage.zoom`` within 1e-5 of its largest
  value (the projector's tolerance in ``tests/test_torch_data_gen.py``);
  the sweep's rays against JAX's rays (rtol 1e-6, atol 1e-7: the geometry's
  f32 arithmetic).
- The batch sweep's isolated step at 32 rays x 8 samples on a 2^14 table
  against the JAX script's ``loss``, ``jax.grad`` and ``one`` (its Adam
  step): the loss to rtol 1e-5, MLP gradients to 1e-4 and table gradients
  to 1e-3 of their largest entry (JAX's two-pass bf16 bucket), parameters
  after the step to 1e-3 * lr where the gradient exceeds 1e-6 and 2 * lr
  elsewhere (the tolerances of ``tests/test_torch_train.py``).
- The sweep's Markdown writer, the scripts' output paths, and every
  script's refusal to run without a card unless ``--device cpu``.
"""

import ast
import dataclasses
import functools
import importlib
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from scipy.ndimage import zoom  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu import config as jconfig  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu import geometry as JG  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu import losses as jlosses  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu import render as jrender  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.data import format_real as jfmt  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.data import projector as jproj  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.train import optim as joptim  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.train import trainer as jtrainer  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.utils import logging as jlogging  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.models import params_from_jax  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.train import optim as toptim  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as ttrainer  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.utils.logging import (  # noqa: E402
    ExperimentLogger,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
r5 = importlib.import_module("real_scale_train_r5_torch")
rtrain = importlib.import_module("real_scale_train_torch")
rsmoke = importlib.import_module("real_scale_smoke_torch")
sweep = importlib.import_module("batch_sweep_torch")

N_VIEWS, DET, SHAPE = 7, 32, (16, 16, 8)
# a 3-level 2^14 table (JAX's Pallas path) and a narrow MLP
SMALL = {"encoder": {"num_levels": 3, "log2_hashmap_size": 14, "base_resolution": 8},
         "network": {"hidden_dim": 16}}


def _small(cfg):
    for section, over in SMALL.items():
        cfg[section].update(over)
    return cfg


def _script(name):
    """The syntax tree of ``scripts/<name>.py``."""
    return ast.parse((REPO / "scripts" / f"{name}.py").read_text())


def _function(name, func):
    return next(n for n in ast.walk(_script(name))
                if isinstance(n, ast.FunctionDef) and n.name == func)


def _run(name, func, stmts, ns):
    """Run ``stmts`` (statements of the JAX script's ``func``) in ``ns``."""
    exec(compile(ast.Module(stmts, type_ignores=[]), name, "exec"), ns)
    return ns


def _span(name, func, first, last):
    """The statements of ``func`` from the one whose source starts with
    ``first`` to the one that starts with ``last``, both included."""
    body = _function(name, func).body
    src = [ast.unparse(n) for n in body]
    i = next(k for k, t in enumerate(src) if t.startswith(first))
    j = next(k for k, t in enumerate(src) if t.startswith(last))
    return body[i:j + 1]


def _cfg_stmts(name, func):
    """The statements of ``func`` that build ``cfg``, in order."""
    return [n for n in _function(name, func).body
            if isinstance(n, (ast.Assign, ast.Expr)) and ast.unparse(n).startswith("cfg")]


def _in_repo(fn):
    """``fn()`` with the repository as the working directory (configs
    resolve ``inherit_from`` against it)."""
    prev = os.getcwd()
    os.chdir(REPO)
    try:
        return fn()
    finally:
        os.chdir(prev)


def _dicts_equal(got, want, path=""):
    assert type(got) is type(want) or (isinstance(got, (list, tuple))
                                       and isinstance(want, (list, tuple))), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _dicts_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def small_stack():
    """7 views of 32^2 of a 16 x 16 x 8 smoothed chip phantom at
    measured angles, projected by the port on the CPU.  The source is
    moved to 5 cm: the tilted beam's rays reach the centre at DSO / cos(29
    degrees), which lies beyond the depth range ``get_near_far`` gives a
    volume this small at 1 m, so every view would be empty."""
    angles_deg = r5.real_angles_deg()[::27][:N_VIEWS]
    geo, vol = r5.gen_geo_vol(SHAPE, (DET, DET))
    geo = dataclasses.replace(geo, DSD=0.075, DSO=0.05)
    proj = r5.project(vol, geo, angles_deg, "cpu")
    assert (proj > 0).mean() > 0.4
    return proj, vol, angles_deg, geo


# ---- the masked eval ----

@pytest.fixture(scope="module")
def eval_pair(small_stack, tmp_path_factory):
    """The JAX ``Trainer`` and the port's on one formatted complex scan,
    the port's field loaded with JAX's parameters (a random table)."""
    proj, vol, angles_deg, _ = small_stack
    tmp = tmp_path_factory.mktemp("real_scale_eval")
    path = tmp / "scan.pickle"
    with open(path, "wb") as f:
        pickle.dump(r5.make_data(proj, vol, angles_deg), f)
    cfg = {"exp": {"expname": "e", "expdir": str(tmp), "datadir": str(path)},
           "network": {"bound": 0.3},
           "render": {"n_samples": 16, "netchunk": 4096},
           "train": {"epoch": 0, "n_rays": 64, "resume": False},
           "log": {"i_eval": 1, "i_save": 0, "eval_mask": True}}
    jcfg = _small(_in_repo(lambda: jconfig.with_defaults(
        jconfig.load_config("configs/chest_50.yaml"))))
    for k, v in cfg.items():
        jcfg[k].update(v)
    tcfg = {k: dict(v) for k, v in jcfg.items()}
    # the trainers log JSONL only (TensorBoard's import is slow)
    saved = jtrainer.ExperimentLogger, ttrainer.ExperimentLogger
    jtrainer.ExperimentLogger = functools.partial(jlogging.ExperimentLogger,
                                                  enable_tensorboard=False)
    ttrainer.ExperimentLogger = functools.partial(ExperimentLogger,
                                                  enable_tensorboard=False)
    try:
        jtr = jtrainer.Trainer(jcfg, workdir=str(tmp / "jax"))
        ttr = ttrainer.Trainer(tcfg, workdir=str(tmp / "torch"), device="cpu")
    finally:
        jtrainer.ExperimentLogger, ttrainer.ExperimentLogger = saved
    params = jtr.state["params"]["coarse"]
    rng = np.random.default_rng(0)
    table = 0.5 + 0.3 * rng.normal(size=params["encoder"]["table"].shape)
    params["encoder"]["table"] = jnp.asarray(table.astype(np.float32))
    jtr.state["params"]["coarse"] = params
    ttr.field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    assert jtr.use_mask and ttr.use_mask
    return jtr, ttr


@pytest.mark.parametrize("masked", [True, False], ids=["eval_mask", "unmasked"])
def test_eval_matches_jax(eval_pair, masked):
    jtr, ttr = eval_pair
    for tr in (jtr, ttr):
        tr.cfg["log"]["eval_mask"] = masked
    want, got = jtr.eval_step(0, 0), ttr.eval_step(0, 0)
    assert sorted(got) == sorted(want) == ["proj_mse", "proj_psnr", "psnr_3d", "ssim_3d"]
    np.testing.assert_allclose(got["proj_mse"], want["proj_mse"], rtol=1e-4)
    for k in ("proj_psnr", "psnr_3d"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["ssim_3d"], want["ssim_3d"], rtol=0, atol=1e-6)


def test_masked_eval_differs_from_unmasked(eval_pair):
    """The beam mask zeroes the pixels outside the beam in both images, so
    the masked projection error is the unmasked one's inside the beam."""
    _, ttr = eval_pair
    out = {}
    for masked in (True, False):
        ttr.cfg["log"]["eval_mask"] = masked
        out[masked] = ttr.eval_step(0, 0)
    kept = float(ttr.eval_dset.mask[int(np.random.default_rng(0).integers(N_VIEWS))].mean())
    assert 0.5 < kept < 1.0
    assert out[True]["proj_mse"] < out[False]["proj_mse"]
    assert out[True]["psnr_3d"] == out[False]["psnr_3d"]


# ---- the scripts' data functions against the JAX scripts ----

@pytest.mark.parametrize("script", ["real_scale_train_r5", "real_scale_train"])
def test_make_data_matches_jax_script(script, small_stack):
    """The complex scan of a small stack on the real scan's grid: the
    statements of the JAX script's ``main`` from the phase to the dict,
    run on the same arrays, bit-equal."""
    proj, _, angles_deg, _ = small_stack
    vol = np.random.default_rng(1).random((256, 256, 64), np.float32)
    port = {"real_scale_train_r5": r5, "real_scale_train": rtrain}[script]
    got = port.make_data(proj, vol, angles_deg)
    first = "phase_max" if script.endswith("r5") else "phase ="
    ns = _run(script, "main", _span(script, "main", first, "data.update"),
              {"np": np, "format_real_data": jfmt.format_real_data, "proj": proj,
               "vol": vol, "angles_deg": angles_deg, "H": DET, "W": DET})
    _dicts_equal(got, ns["data"])
    assert np.iscomplexobj(got["full_proj"]) and got["nVoxel"] == [256, 256, 64]


def test_projector_check_reads_the_host_projector(small_stack):
    """The stack against the host projector on the views asked for: within
    0.02 of the largest value (interpolation accuracy, the tolerance of
    the two projectors in ``tests/test_torch_data_gen.py``)."""
    proj, vol, angles_deg, geo = small_stack
    res = r5.projector_check(proj, vol, geo, angles_deg, views=(0, 3, 6))
    assert res["views"] == [0, 3, 6]
    assert res["max_abs_diff"] < 0.02 * res["max_value"]
    assert res["pixels"] == 3 * DET * DET


def test_upsampled_stack_matches_jax():
    """``real_scale_train_torch``'s stack on a detector of 1/32 the side:
    3 views of the 256 x 256 x 64 chip phantom projected at 8^2 (4 mm
    pixels) and zoomed to 32^2 (1 mm), against JAX's ``project_angles`` and
    the same zoom."""
    angles_deg = r5.real_angles_deg()[:3]
    got, vol = rtrain.upsampled_stack(angles_deg, "cpu", lo=8, det=32)
    geo = JG.ConeGeometry(DSD=1.5, DSO=1.0, nDetector=(8, 8), dDetector=(0.004, 0.004),
                          nVoxel=(256, 256, 64), dVoxel=(0.0015, 0.0015, 0.0015),
                          mode="parallel", tilt_angle=29.0)
    lo = np.asarray(jproj.project_angles(jnp.asarray(vol), geo,
                                         np.deg2rad(angles_deg).astype(np.float32), 320))
    want = zoom(lo, (1, 4, 4), order=1).astype(np.float32)
    assert got.shape == want.shape == (3, 32, 32) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_smoke_scan_dict_matches_jax_script():
    """The real-scale smoke's geometry dict (3 views of 16 x 24 here), the
    random stack included, against the JAX script's ``data = {...}``."""
    angles = np.load(REPO / "data" / "angles_real.npy").astype(np.float32)[:3]
    stmt = next(n for n in _function("real_scale_smoke", "main").body
                if isinstance(n, ast.Assign) and ast.unparse(n).startswith("data ="))
    ns = _run("real_scale_smoke", "main", [stmt],
              {"np": np, "angles": angles, "N_VIEWS": 3, "H": 16, "W": 24})
    _dicts_equal(_in_repo(lambda: rsmoke.scan_dict(3, 16, 24)), ns["data"])


# ---- the configs against the JAX scripts ----

def _jax_cfg(script, func, **names):
    ns = {"load_config": jconfig.load_config, "with_defaults": jconfig.with_defaults,
          "os": os, **names}
    return _run(script, func, _cfg_stmts(script, func), ns)["cfg"]


@pytest.mark.parametrize("case", ["r5_400", "r5_50", "train_12", "smoke",
                                  "sweep_1024_f32", "sweep_8192_bf16"])
def test_configs_match_jax_scripts(case, monkeypatch):
    monkeypatch.chdir(REPO)
    monkeypatch.delenv("NVR_RS_RAYS", raising=False)
    if case.startswith("r5"):
        epochs = int(case.split("_")[1])
        got = r5.run_cfg(epochs, 4096)
        want = _jax_cfg("real_scale_train_r5", "main", epochs=epochs, N_RAYS=4096)
    elif case == "train_12":
        got = rtrain.run_cfg(12, 1024)
        want = _jax_cfg("real_scale_train", "main", EPOCHS=12)
    elif case == "smoke":
        got = rsmoke.smoke_cfg()
        want = _jax_cfg("real_scale_smoke", "main", N_SAMPLES=192)
    else:
        _, n, dtype = case.split("_")
        dtype = {"f32": "float32", "bf16": "bfloat16"}[dtype]
        got = sweep.sweep_cfg(int(n), dtype)
        want = _jax_cfg("batch_sweep", "build", N_SAMPLES=192, n_rays=int(n),
                        table_dtype=dtype)
    assert got == want


@pytest.fixture(scope="module")
def sweep_arrays():
    return sweep.scan_arrays("cpu")


def test_sweep_scan_rays_match_jax(sweep_arrays):
    """The sweep's 50-view 256^2 cone scan (its first 2 views' rays) and
    its arrays' layout against the JAX script's ``build``."""
    arrays = sweep_arrays
    geo = JG.ConeGeometry(DSD=1.5, DSO=1.0, nDetector=(256, 256), dDetector=(0.002, 0.002),
                          nVoxel=(128, 128, 128), dVoxel=(0.002, 0.002, 0.002),
                          mode="cone")
    near, far = JG.get_near_far(geo)
    angles = np.linspace(0, np.pi, 50, endpoint=False).astype(np.float32)
    ro, rd = JG.rays_for_angles(geo, angles[:2])
    want = np.asarray(JG.pack_rays(ro, rd, near, far))
    np.testing.assert_allclose(arrays["rays"][:2].numpy(), want, rtol=1e-6, atol=1e-7)
    assert arrays["rays"].shape == (50, 256, 256, 8)
    assert arrays["projs"].shape == arrays["mask"].shape == (50, 256, 256)
    assert float(arrays["projs"].min()) >= 0 and float(arrays["projs"].max()) < 0.1
    assert torch.equal(arrays["pools"][7], torch.arange(256 * 256, dtype=torch.int32))
    assert arrays["pool_counts"].tolist() == [256 * 256] * 50


# ---- the batch sweep's isolated step ----

def test_iso_step_matches_jax(sweep_arrays):
    n_rays, n_samples = 32, 8
    cfg_t = _small(_in_repo(lambda: sweep.sweep_cfg(n_rays, "bfloat16")))
    cfg_j = _small(_in_repo(lambda: _jax_cfg(
        "batch_sweep", "build", N_SAMPLES=n_samples, n_rays=n_rays, table_dtype="bfloat16")))
    cfg_t["render"]["n_samples"] = n_samples
    assert cfg_t == cfg_j
    spec = jtrainer.build_model(cfg_j)
    params = spec.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    params["encoder"]["table"] = jnp.asarray(
        0.1 * rng.normal(size=params["encoder"]["table"].shape).astype(np.float32))
    rays = sweep_arrays["rays"].reshape(-1, 8)[:n_rays]
    target = (0.1 * rng.random(n_rays)).astype(np.float32)

    build = _function("batch_sweep", "build")
    defs = {n.name: n for n in build.body if isinstance(n, ast.FunctionDef)}
    opt = joptim.make_optimizer(cfg_j, 8)
    ns = _run("batch_sweep", "build", [defs["loss"]],
              {"render_rays": jrender.render_rays, "masked_mse": jlosses.masked_mse,
               "target": jnp.asarray(target), "spec": spec, "N_SAMPLES": n_samples})
    ns["g"], ns["opt"] = jax.grad(ns["loss"]), opt
    _run("batch_sweep", "build", [defs["one"]], ns)
    jp = {"coarse": params}
    jr = jnp.asarray(rays.numpy())
    jl, jg = jax.jit(jax.value_and_grad(ns["loss"]))(jp, jr)
    jg = jg["coarse"]
    jnew, _ = jax.jit(ns["one"])((jp, opt.init(jp)), jr)
    jnew = jnew["coarse"]

    field = ttrainer.build_model(cfg_t)
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    loss = sweep.iso_loss(field, rays, torch.as_tensor(target), n_samples)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)

    def close(t, j, rel):
        j = np.asarray(j)
        np.testing.assert_allclose(t, j, rtol=0, atol=rel * np.abs(j).max())

    close(field.table.grad.numpy(), jg["encoder"]["table"], 1e-3)
    for i, lin in enumerate(field.layers):
        close(lin.weight.grad.numpy(), np.asarray(jg["layers"][i]["w"]).T, 1e-4)
        close(lin.bias.grad.numpy(), jg["layers"][i]["b"], 1e-4)

    field2 = ttrainer.build_model(cfg_t)
    field2.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tor = toptim.make_optimizer(cfg_t, field2.parameters())
    step_loss = sweep.make_iso_step(field2, tor, rays, torch.as_tensor(target), n_samples)(
        {}, None)
    assert torch.equal(step_loss, loss.detach())
    lr = cfg_t["train"]["lrate"]

    def adam_close(t, j, g):
        big = np.abs(np.asarray(g)) > 1e-6
        d = np.abs(t - np.asarray(j))
        assert d[big].max() <= 1e-3 * lr and d.max() <= 2 * lr

    adam_close(field2.table.detach().numpy(), jnew["encoder"]["table"],
               jg["encoder"]["table"])
    for i, lin in enumerate(field2.layers):
        adam_close(lin.weight.detach().numpy(), np.asarray(jnew["layers"][i]["w"]).T,
                   np.asarray(jg["layers"][i]["w"]).T)


# ---- the writer, the paths, the card ----

def test_sweep_report():
    rec = {"n_rays": 1024, "table_dtype": "bfloat16", "points_a_level": 196608,
           "epoch_ms": 3.5, "epoch_rays_s": 292571.4, "epoch_device_ms": 3.46,
           "iso_ms": 3.4, "iso_rays_s": 301176.5, "iso_device_ms": None,
           "peak_mb": 1200.0, "warm_s": 1.25}
    text = sweep.report([rec, dict(rec, n_rays=8192, points_a_level=1572864,
                                   peak_mb=None)], "CARD, 700.00 W", 8)
    rows = [line for line in text.splitlines() if line.startswith("| bfloat16")]
    assert rows[0] == ("| bfloat16 | 1024 | 196,608 | 3.500 | 292,571 | 3.460 | 3.400 | "
                       "301,176 | n/a | 1200.0 | 1.25 |")
    assert rows[1].startswith("| bfloat16 | 8192 | 1,572,864 |") and "| n/a | 1.25 |" in rows[1]
    assert "--steps 8" in text and "Card: CARD, 700.00 W" in text


def test_scripts_write_their_own_paths():
    assert r5.OUTDIR == "docs/real_scale_torch/train_r5"
    assert rtrain.OUTDIR == "docs/real_scale_torch/train"
    assert rsmoke.OUT == "docs/real_scale_torch/smoke.md"
    assert sweep.OUT == "docs/batch_scaling_torch.md"
    for mod in (r5, rtrain):
        assert mod.WORKDIR.startswith("logs/")
        assert os.path.basename(mod.GEN_NPZ).startswith("nvr_realscale_gen_torch")
    assert r5.GEN_NPZ != rtrain.GEN_NPZ


@pytest.mark.parametrize("mod", [r5, rtrain, rsmoke, sweep],
                         ids=["r5", "train", "smoke", "sweep"])
def test_scripts_need_a_card(mod, monkeypatch):
    """Without ``--device cpu`` each script runs on the card, and raises
    when there is none, before it makes or writes anything."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
