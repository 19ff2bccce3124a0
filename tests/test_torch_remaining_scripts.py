"""The last JAX scripts' ports, on the CPU at small sizes, against the JAX
scripts read with ``ast`` (they run at import, or hold their worker as a
string) and against the JAX package.

- ``verify_drive_torch``: every constant, the thresholds and the rate
  schedule against ``scripts/verify_drive.py`` (the schedule against
  optax's own ``piecewise_constant_schedule`` at the updates around its
  boundaries, rtol 1e-6: optax multiplies in f32); the parallel-beam rays
  and the ball's chords against the JAX statements (rtol 1e-6, atol 1e-7:
  the geometry's f32 arithmetic); one step against JAX on a 2^11 table
  (JAX's Pallas path, in interpret mode), JAX's parameters carried across,
  the ray indices and the stratified jitter fed from JAX's side: the loss
  to rtol 1e-5, the parameters after the Adam step within 1e-3 * lr where
  the gradient exceeds 1e-6 and 2 * lr elsewhere (the tolerances of
  ``tests/test_torch_train.py``; measured 1.2e-7 and 1.7e-4); the draw
  without replacement.
- ``quality_summary_torch``: its reading of a log row for row against the
  JAX script's, run whole on synthetic ``metrics.jsonl`` files, missing
  runs included; its tables and copies.
- Resume across configs: a tiny r3-shaped run saved at epoch 2 and resumed
  under another ``lrate_step`` (and another ``n_samples``): the rate equal
  to JAX's ``make_lr_schedule`` of the new config (rtol 1e-6: JAX forms it
  in f32, 1 ulp from the port's at 1e-4), the resumed losses
  bit-equal to an uninterrupted run where the configs agree; and
  ``train_full_torch``'s rule that a resuming config keeps its directory.
- ``multiprocess_smoke_torch``: two gloo ranks on the CPU with identical
  digests; the worker's config and scan against the JAX worker's.
- ``shard_overhead_torch`` and ``scaling_sweep_torch`` at a tiny size: the
  payload is the parameter count x 4 bytes, the rows finite, the
  efficiency the JAX script's formula.
- Every new script raises without a card unless ``--device cpu`` (the
  quality study, whose runs are the card's, has no CPU mode).
"""

import ast
import functools
import importlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu import geometry as JG  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu import models as jmodels  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu import render as jrender  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.config import (  # noqa: E402
    with_defaults as jwith_defaults)
from neuralvolumetricreconstructionformedicalimages_tpu.train import optim as joptim  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.config import load_config  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.models import params_from_jax  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as ttrainer  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.utils.logging import (  # noqa: E402
    ExperimentLogger)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
vd = importlib.import_module("verify_drive_torch")
qs = importlib.import_module("quality_summary_torch")
mps = importlib.import_module("multiprocess_smoke_torch")
so = importlib.import_module("shard_overhead_torch")
sw = importlib.import_module("scaling_sweep_torch")
tf = importlib.import_module("train_full_torch")


def _tree(name):
    return ast.parse((REPO / "scripts" / f"{name}.py").read_text())


def _calls(tree, name):
    """Every call in ``tree`` whose function's source ends with ``name``,
    in source order."""
    def named(call):
        func = ast.unparse(call.func)
        return func == name or func.endswith("." + name)

    return sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call) and named(n)),
                  key=lambda n: (n.lineno, n.col_offset))


def _value(node, **names):
    """A constant expression of the JAX script, evaluated."""
    return eval(compile(ast.Expression(node), "jax_script", "eval"), dict(names))


def _kwargs(call, **names):
    return {k.arg: _value(k.value, **names) for k in call.keywords}


def _assigned(tree, target):
    return next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) == target)


def _run(tree, stmts, ns):
    exec(compile(ast.Module(list(stmts), type_ignores=[]), "jax_script", "exec"), ns)
    return ns


# ---- verify_drive ----

def test_verify_constants_match_jax_script():
    t = _tree("verify_drive")
    geo = _calls(t, "ConeGeometry")[0]
    assert _kwargs(geo) == vd.GEOMETRY
    enc = _calls(t, "get_encoder")[0]
    assert _value(enc.args[0]) == "hashgrid" and _kwargs(enc) == vd.ENCODER
    net = next(c for c in ast.walk(t) if isinstance(c, ast.Call)
               and isinstance(c.func, ast.Call) and ast.unparse(c.func) == "get_network('mlp')")
    assert {k: v for k, v in _kwargs(net, enc=None).items() if k != "encoder"} == vd.NETWORK
    sched = _calls(t, "piecewise_constant_schedule")[0]
    assert [_value(a) for a in sched.args] == [vd.LR0, vd.LR_SCALES]
    render = _calls(t, "render_rays")[0]
    kw = _kwargs(render, key=None)
    assert kw["n_samples"] == vd.N_SAMPLES and kw["perturb"] is True and kw["n_fine"] == 0
    assert kw["raw_noise_std"] == 0.0
    choice = _calls(t, "random.choice")[0]
    assert _value(choice.args[2]) == (vd.N_RAYS,) and _kwargs(choice)["replace"] is False
    assert _value(_calls(t, "random.split")[1].args[1]) == vd.BLOCK_STEPS
    assert _value(_calls(t, "range")[0].args[0]) == vd.BLOCKS
    assert _value(_assigned(t, "r")) == vd.RADIUS
    lin = _calls(t, "linspace")
    assert [_value(a, np=np) for a in lin[0].args] == [0, np.pi, vd.N_ANGLES]
    assert [_value(a) for a in lin[1].args] == [-vd.GRID_EXTENT, vd.GRID_EXTENT, vd.GRID]
    assert _kwargs(_calls(t, "query_field")[0])["tile"] == vd.QUERY_TILE
    ok = _assigned(t, "ok")
    assert [_value(c.comparators[0]) for c in ok.values] == [
        vd.PSNR_MIN, vd.INSIDE_MIN, vd.OUTSIDE_MAX]
    assert [type(c.ops[0]) for c in ok.values] == [ast.Gt, ast.Gt, ast.Lt]
    dead = _assigned(t, "DEADLINE_S")
    assert _value(dead.orelse) == vd.DEADLINE_S
    # the eval's inner/outer radii
    assert "f[rad < 0.8 * r]" in ast.unparse(t) and "f[rad > 1.2 * r]" in ast.unparse(t)


def test_verify_schedule_matches_optax():
    t = _tree("verify_drive")
    stmt = next(n for n in t.body if ast.unparse(n).startswith("sched ="))
    sched = _run(t, [stmt], {"optax": optax})["sched"]
    updates = [0, 1499, 1500, 2499, 2500] + [b * vd.BLOCK_STEPS for b in range(vd.BLOCKS)]
    for u in updates:
        np.testing.assert_allclose(vd.lr_at(u), float(sched(u)), rtol=1e-6, err_msg=str(u))
    assert [vd.lr_at(u) for u in (0, 1500, 2500)] == [1e-2, 1e-2 * 0.1, 1e-2 * 0.1 * 0.3]


@pytest.fixture(scope="module")
def verify_scan():
    return vd.scan("cpu")


def test_verify_scan_matches_jax(verify_scan):
    t = _tree("verify_drive")
    src = [ast.unparse(n) for n in t.body]
    i = next(k for k, s in enumerate(src) if s.startswith("geo ="))
    j = next(k for k, s in enumerate(src) if s.startswith("gt ="))
    ns = _run(t, t.body[i:j + 1], {"G": JG, "np": np, "jnp": jnp})
    rays, gt = verify_scan
    assert rays.shape == (vd.N_ANGLES * 24 * 24, 8) and gt.shape == (rays.shape[0],)
    np.testing.assert_allclose(rays.numpy(), np.asarray(ns["rays"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gt.numpy(), np.asarray(ns["gt"]), rtol=1e-6, atol=1e-7)
    assert (gt > 0).sum() > 500 and float(gt.max()) <= 2 * vd.RADIUS


def test_verify_draw_without_replacement():
    g = torch.Generator().manual_seed(0)
    idx = vd.draw_indices(g, 9216, 3, "cpu")
    assert idx.shape == (3, vd.N_RAYS) and idx.dtype == torch.int64
    for row in idx:
        assert len(torch.unique(row)) == vd.N_RAYS and 0 <= int(row.min()) < int(row.max()) < 9216
    assert not torch.equal(idx[0], idx[1])


def test_verify_step_matches_jax(verify_scan, monkeypatch):
    """One step on a 2^11 table, 64 rays, JAX's jitter."""
    n = 64
    enc_cfg = dict(vd.ENCODER, log2_hashmap_size=11)
    t = _tree("verify_drive")
    loss_def = next(n for n in t.body if isinstance(n, ast.FunctionDef) and n.name == "loss_fn")
    opt_stmts = [n for n in t.body if ast.unparse(n).startswith(("sched =", "opt ="))]
    spec = jmodels.get_network("mlp")(encoder=jmodels.get_encoder("hashgrid", **enc_cfg),
                                      **vd.NETWORK)
    ns = _run(t, [loss_def, *opt_stmts], {"render_rays": jrender.render_rays, "jnp": jnp,
                                          "spec": spec, "optax": optax})
    params = spec.init(jax.random.key(0))
    rays_t, gt_t = verify_scan
    # half the rays through the ball, half around it
    hit = np.flatnonzero(gt_t.numpy() > 0)
    rng = np.random.default_rng(0)
    idx = np.concatenate([rng.choice(hit, n // 2, replace=False),
                          rng.choice(np.flatnonzero(gt_t.numpy() == 0), n // 2, replace=False)])
    rays, gt = jnp.asarray(rays_t.numpy()), jnp.asarray(gt_t.numpy())
    key = jax.random.key(5)
    jl, jg = jax.value_and_grad(ns["loss_fn"])(params, rays[idx], gt[idx], key)
    opt = ns["opt"]
    up, _ = opt.update(jg, opt.init(params), params)
    jnew = optax.apply_updates(params, up)
    # the renderer's stratified jitter under that key
    t_rand = jax.random.uniform(jax.random.split(key, 4)[0], (n, vd.N_SAMPLES))

    monkeypatch.setattr(vd, "ENCODER", enc_cfg)
    field, optimizer = vd.build("cpu")
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    step = vd.make_step(field, optimizer, None)
    loss = step({"rays": rays_t, "gt": gt_t}, torch.as_tensor(idx),
                t_rand=torch.as_tensor(np.array(t_rand)))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    lr = vd.LR0

    def adam_close(got, want, grad):
        big = np.abs(np.asarray(grad)) > 1e-6
        d = np.abs(got - np.asarray(want))
        assert d[big].max(initial=0) <= 1e-3 * lr and d.max() <= 2 * lr

    adam_close(field.table.detach().numpy(), jnew["encoder"]["table"], jg["encoder"]["table"])
    for i, lin in enumerate(field.layers):
        adam_close(lin.weight.detach().numpy(), np.asarray(jnew["layers"][i]["w"]).T,
                   np.asarray(jg["layers"][i]["w"]).T)
        adam_close(lin.bias.detach().numpy(), jnew["layers"][i]["b"], jg["layers"][i]["b"])


def test_verify_report():
    rec = {"steps": 3500, "ms_per_step": 1.234, "first_block_s": 2.5, "proj_psnr": 55.0,
           "inside": 0.95, "outside": 0.01, "eval_s": 0.5, "ok": True,
           "blocks": [{"steps": 100, "lr": 1e-2, "loss": 1e-4, "wall_s": 2.5}]}
    text = vd.report(rec, "CARD, 700.00 W")
    assert "Card: CARD, 700.00 W." in text and "VERIFY PASS" in text
    assert "| 100 | 1e-02 | 1.000e-04 | 2.50 |" in text and "1.234 ms a step" in text


# ---- quality_summary ----

def _metrics(path, psnr, ssim=None, steps=None):
    path.parent.mkdir(parents=True, exist_ok=True)
    steps = steps or [50 * i for i in range(len(psnr))]
    with open(path, "w") as f:
        for k, (s, v) in enumerate(zip(steps, psnr)):
            f.write(json.dumps({"t": 0.0, "step": s, "tag": "train/loss", "value": 0.1}) + "\n")
            f.write(json.dumps({"t": 0.0, "step": s, "tag": "eval/psnr_3d", "value": v}) + "\n")
            if ssim is not None:
                f.write(json.dumps({"t": 0.0, "step": s, "tag": "eval/ssim_3d",
                                    "value": ssim[k]}) + "\n")


# synthetic logs: (psnr_3d per eval, ssim_3d per eval or None); None = no log
SYNTH = {
    "chest_phantom_r3": ([7.0, 22.4, 21.4], [0.1, 0.5, 0.45]),
    "chest_phantom_views100": ([6.9, 22.8, 22.1], None),
    "chest_phantom_views200": None,
    "chest_phantom_views200_b01": ([], None),
    "chest_phantom_tvd": ([5.5, 20.0], [0.2, 0.6]),
    "chest_phantom_smooth": ([30.1], [0.9]),
}


def test_summary_matches_jax_script(tmp_path, monkeypatch, capsys):
    """The JAX script, run whole in a directory of synthetic ``logs/<exp>``,
    and the port's reading of the same files: row for row."""
    for exp, spec in SYNTH.items():
        if spec is None:
            continue
        _metrics(tmp_path / "logs" / exp / "metrics.jsonl", *spec)
        (tmp_path / "logs" / exp / "eval" / "epoch_00001").mkdir(parents=True)
        (tmp_path / "logs" / exp / "eval" / "epoch_00001" / "stats.txt").write_text("x\n")
    monkeypatch.chdir(tmp_path)
    t = _tree("quality_summary")
    ns = _run(t, t.body, {"__name__": "quality_summary"})
    printed = capsys.readouterr().out
    jax_rows = {exp: row[2:] for (exp, _), row in zip(ns["RUNS"], ns["rows"])}
    assert [e for e, _ in ns["RUNS"]] == [e for e, _ in qs.RUNS]
    for exp in jax_rows:
        got = qs.summarize(str(tmp_path / "logs" / exp / "metrics.jsonl"))
        want = jax_rows[exp]
        if want[0] is None:
            assert got is None, exp
        else:
            np.testing.assert_equal(got, want, err_msg=exp)
    assert printed.count("(missing)") == 2 == sum(
        qs.summarize(str(tmp_path / "logs" / e / "metrics.jsonl")) is None for e in SYNTH)


def test_summary_tables_and_copies(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    logs = tmp_path / "logs"
    for name, spec in (("chest_phantom_r3", SYNTH["chest_phantom_r3"]),
                       ("chest_phantom_tvd", SYNTH["chest_phantom_tvd"])):
        cfg = qs.config_of(name)
        _metrics(Path(qs.port_metrics(name, str(logs))), *spec)
        ev = Path(qs.last_eval_dir(name, str(logs)))
        ev.mkdir(parents=True)
        (ev / "stats.txt").write_text("psnr_3d: 1\n")
        (ev / "slice_show_row1_gt_row2_pred.png").write_bytes(b"png")
        (ev / "image_pred.npy").write_bytes(b"npy")
        assert ev.name == f"epoch_{int(cfg['train']['epoch']):05d}"
    out = tmp_path / "out"
    rows = qs.collect(qs.RUNS, str(out), str(logs))
    assert [r[0] for r in rows] == [e for e, _ in qs.RUNS]
    assert rows[0][2] == (22.4, 21.4, 0.45)
    # the JAX figures come from the committed logs
    assert rows[0][3] == qs.summarize(qs.JAX_METRICS["chest_phantom_r3"])
    np.testing.assert_allclose(rows[0][3][0], 22.36, atol=0.01)
    assert rows[1][2] is None and rows[1][3] is not None
    assert sorted(os.listdir(out)) == sorted([
        "metrics_chest_phantom_r3.jsonl", "metrics_chest_phantom_tvd.jsonl",
        "chest_phantom_r3_stats.txt", "chest_phantom_r3_slice_show_row1_gt_row2_pred.png",
        "chest_phantom_tvd_stats.txt", "chest_phantom_tvd_slice_show_row1_gt_row2_pred.png"])
    text = qs.table(rows)
    assert "| 50 views (r3) (`chest_phantom_r3`) | 22.40 | 21.40 | 0.450 | 22.36 |" in text
    assert "| 100 views, same phantom+val (`chest_phantom_views100`) | (missing) | | " in text
    chest = qs.collect(qs.CHEST_RUNS, str(tmp_path / "chest"), str(logs))
    assert "(no JAX log)" in qs.table(chest)       # consolidate alone has none
    assert all(os.path.exists(REPO / p) for p in qs.JAX_METRICS.values())
    assert set(qs.STUDY) == {e for e, _ in qs.RUNS + qs.CHEST_RUNS}


# ---- resume across configs ----

def _tiny_cfg(**train):
    cfg = load_config(str(REPO / "configs" / "smoke.yaml"))
    cfg["exp"]["datadir"] = str(REPO / "data" / "smoke.pickle")
    cfg["encoder"].update(num_levels=4, log2_hashmap_size=12)
    cfg["render"]["n_samples"] = 16
    cfg["train"].update(n_rays=64, **train)
    cfg["log"].update(i_eval=0, i_save=1)
    return cfg


@pytest.fixture
def jsonl_logger(monkeypatch):
    monkeypatch.setattr(ttrainer, "ExperimentLogger",
                        functools.partial(ExperimentLogger, enable_tensorboard=False))


@pytest.mark.parametrize("over", [{}, {"n_samples": 24}], ids=["lrate_step", "n_samples"])
def test_resume_across_configs(tmp_path, jsonl_logger, monkeypatch, over):
    """Epochs 0-2 under the first config (StepLR every 20 epochs), saved at
    epoch 2; epochs 3-4 resumed under one with ``lrate_step`` 3 (the decay
    fires at the resumed epoch) and, in the second case, other
    ``n_samples``."""
    monkeypatch.chdir(REPO)
    first = ttrainer.Trainer(_tiny_cfg(epoch=2), workdir=str(tmp_path / "run"), device="cpu")
    first.start()
    assert [os.path.basename(p) for p in first._checkpoints()] == [
        "ckpt_000001.pt", "ckpt_000002.pt"]
    cfg = _tiny_cfg(epoch=4, lrate_step=3, resume=True)
    cfg["render"].update(over)
    tr = ttrainer.Trainer(cfg, workdir=str(tmp_path / "run"), device="cpu")
    spe = tr.steps_per_epoch
    assert (tr.epoch_start, tr.global_step) == (3, 3 * spe)
    jsched = joptim.make_lr_schedule(jwith_defaults(cfg), spe)
    # JAX forms the rate in f32 (one rounding more: 1 ulp off at 1e-4)
    np.testing.assert_allclose(tr.current_lr(), float(jsched(3 * spe)), rtol=1e-6)
    assert tr.current_lr() == pytest.approx(0.1 * tr.schedule(0))
    tr.start()
    assert tr.global_step == 5 * spe
    np.testing.assert_allclose(tr.optimizer.param_groups[0]["lr"], float(jsched(5 * spe - 1)),
                               rtol=1e-6)
    resumed = np.asarray(tr.losses)
    assert resumed.shape == (2 * spe,) and np.isfinite(resumed).all()
    if over:
        assert tr.cfg["render"]["n_samples"] == 24
        return
    # where the configs agree, an uninterrupted run under the second config
    whole = ttrainer.Trainer(_tiny_cfg(epoch=4, lrate_step=3), workdir=str(tmp_path / "whole"),
                             device="cpu")
    whole.start()
    np.testing.assert_array_equal(resumed, np.asarray(whole.losses[3 * spe:]))
    np.testing.assert_array_equal(np.asarray(first.losses), np.asarray(whole.losses[:3 * spe]))


@pytest.mark.parametrize("resume", [False, True])
def test_train_full_keeps_a_resumed_directory(tmp_path, monkeypatch, resume):
    monkeypatch.chdir(tmp_path)
    old = tmp_path / "logs" / "full" / "exp" / "ckpt" / "ckpt_000400.pt"
    old.parent.mkdir(parents=True)
    old.write_bytes(b"x")
    wd = tf.workdir_for({"exp": {"expname": "exp"}, "train": {"resume": resume}})
    assert wd == os.path.join("logs", "full", "exp")
    assert old.exists() == resume
    assert set(tf.MAKERS) == {"./data/chest_phantom_smooth.pickle",
                              "./data/chest_phantom_views100.pickle",
                              "./data/chest_phantom_views200.pickle"}
    monkeypatch.chdir(REPO)
    for name in ("consolidate", "finetune"):
        cfg = load_config(str(REPO / "configs" / f"chest_phantom_{name}.yaml"))
        assert cfg["exp"]["expname"] == "chest_phantom_r3" and cfg["train"]["resume"]


# ---- the multi-process scripts ----

def _worker_tree():
    return ast.parse(_value(_assigned(_tree("multiprocess_smoke"), "WORKER")))


def test_multiprocess_worker_matches_jax():
    t = _worker_tree()
    call = _assigned(t, "cfg")
    assert ast.unparse(call.func) == "with_defaults"
    assert ast.literal_eval(call.args[0]) == mps.worker_cfg()
    src = [ast.unparse(n) for n in t.body]
    i = next(k for k, s in enumerate(src) if s.startswith("geo ="))
    j = next(k for k, s in enumerate(src) if s.startswith("ro, rd ="))
    ns = _run(t, t.body[i:j + 1], {"G": JG, "np": np})
    arrays = mps.worker_arrays("cpu")
    want = np.asarray(JG.pack_rays(ns["ro"], ns["rd"], ns["near"], ns["far"]))
    np.testing.assert_allclose(arrays["rays"].numpy(), want, rtol=1e-6, atol=1e-7)
    assert arrays["projs"].shape == arrays["mask"].shape == (4, 8, 8)
    assert arrays["pools"].shape == (4, 64) and arrays["pool_counts"].tolist() == [64] * 4
    step = _calls(t, "make_sharded_train_step")[0]
    kw = _kwargs(step, cfg=mps.worker_cfg())
    assert kw["steps_per_epoch"] == 4 and kw["n_batch"] == 1 and kw["use_mask"] is False
    assert _value(_calls(t, "range")[0].args[0]) == 2
    assert _value(_assigned(_tree("multiprocess_smoke"), "N_PROC")) == mps.N_PROC


def test_multiprocess_smoke_two_cpu_ranks():
    res = mps.smoke("cpu", port=mps.free_port())
    assert res["ok"] and len(res["ranks"]) == 2
    assert [r["rank"] for r in res["ranks"]] == [0, 1]
    assert {r["backend"] for r in res["ranks"]} == {"gloo"}
    assert res["ranks"][0]["params_sha256"] == res["ranks"][1]["params_sha256"]
    assert np.isfinite(res["ranks"][0]["loss"])
    assert "MULTIPROCESS SMOKE PASSED" in mps.report(res, "CPU")


def test_shard_overhead_tiny():
    cfg = so.chest_cfg(n_rays=64, n_samples=8)
    cfg["encoder"].update(num_levels=2, log2_hashmap_size=11)
    rec = so.run("cpu", steps=2, cfg=cfg, n_views=2, det=(16, 16))
    field = ttrainer.build_model(cfg)
    n = sum(p.numel() for p in field.parameters())
    assert rec["plain"]["n_params"] == n
    assert rec["payload_mib"] * 2 ** 20 == n * 4
    figures = [rec["plain"]["ms_per_step"], rec["mesh1"]["ms_per_step"],
               rec["mesh1_eager"]["ms_per_step"],
               rec["allreduce_1rank_ms"], rec["allreduce_2rank_gloo_ms"]]
    assert np.isfinite(figures).all() and min(figures) > 0
    assert rec["backend_1rank"] == "gloo" and not rec["mesh1_graphed"]
    text = so.report(rec, "CPU")
    assert "No link rate is quoted" in text and f"{n:,} f32 parameters" in text
    assert "mesh of one, eager under gloo" in text


def test_scaling_sweep_tiny():
    rows = sw.sweep("cpu", (1, 2), 64, 8, 11, 2, "take")
    assert [r["ranks"] for r in rows] == [1, 2]
    assert np.isfinite([r["rays_per_s"] for r in rows]).all()
    assert rows[0]["efficiency_vs_1rank"] == 1.0
    # the JAX script's efficiency, read from its source
    stmt = next(n for n in ast.walk(_tree("scaling_sweep")) if isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) == "eff")
    want = _value(stmt.value, rate=rows[1]["rays_per_s"], base_rate=rows[0]["rays_per_s"], n=2)
    assert rows[1]["efficiency_vs_1rank"] == round(want, 3)
    assert sw.efficiency(300.0, 200.0, 2) == 0.75


def test_sweep_cfg_matches_jax_script():
    t = _tree("scaling_sweep")
    stmts = [n for n in ast.walk(t) if isinstance(n, ast.Assign)
             and ast.unparse(n).startswith(("cfg =", "cfg["))]

    class Args:
        n_samples, n_rays, log2_table, backward = 64, 1024, 15, "take"

    from neuralvolumetricreconstructionformedicalimages_tpu.config import load_config as jload
    prev = os.getcwd()
    os.chdir(REPO)
    try:
        want = _run(t, stmts, {"with_defaults": jwith_defaults, "load_config": jload,
                               "args": Args})["cfg"]
    finally:
        os.chdir(prev)
    assert sw.sweep_cfg(1024, 64, 15, "take") == want
    parser_defaults = {_value(c.args[0]): _value(k.value) for c in _calls(t, "add_argument")
                       for k in c.keywords if k.arg == "default"}
    assert parser_defaults == {"--platform": "cpu", "--n-rays": 1024, "--n-samples": 64,
                               "--log2-table": 15, "--steps": 8, "--backward": "take",
                               "--out": None}


# ---- the files, the card ----

def test_scripts_write_their_own_paths():
    assert vd.OUT == "docs/verify_drive_torch.md"
    assert mps.OUT == "docs/multiprocess_smoke_torch.md"
    assert so.OUT == "docs/scaling_standin_torch.md"
    assert sw.OUT == {"cpu": "docs/scaling_sweep_torch_cpu.md",
                      "cuda": "docs/scaling_sweep_torch_card.md"}
    assert (qs.OUT_ATTRIBUTION, qs.OUT_CHEST) == ("docs/quality_attribution_torch",
                                                  "docs/quality_chest_torch")
    assert mps.PORT == int(os.environ.get("NVR_SMOKE_PORT", "43217"))


@pytest.mark.parametrize("mod,argv", [(vd, ["--out", "/nonexistent/x.md"]),
                                      (mps, ["--out", "/nonexistent/x.md"]),
                                      (so, ["--out", "/nonexistent/x.md"]),
                                      (sw, ["--out", "/nonexistent/x.md"]),
                                      (qs, ["--train"])],
                         ids=["verify", "mpsmoke", "shard", "sweep", "quality"])
def test_scripts_need_a_card(mod, argv, monkeypatch):
    """Without ``--device cpu`` each script runs on the card, and raises
    when there is none, before it starts a rank, trains or writes anything
    (the quality study has no CPU mode: its runs and tables are the card's)."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
