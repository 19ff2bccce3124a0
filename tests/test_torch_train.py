"""Port parity of the training stack: one whole training step on a fixed
batch gathered by JAX (loss, table and MLP gradients, parameters after one
Adam step) through the main-path encoder (sorted forward, bf16 table,
packed payloads; JAX's Pallas kernels in interpret mode); the LR schedule
and the loss registry; and the port's own ``Trainer`` on
``configs/smoke.yaml`` on the CPU (falling loss, checkpoint, resume).

Tolerances, with their reasons: the loss is a mean of f32 line integrals
(rtol 1e-5); MLP gradients are f32 sums over 64 x 32 samples (rtol 1e-4
of the largest entry); table gradients go through JAX's two-pass bf16
bucket contraction (JAX ``bucket_matmul.py:160-169``), so they agree to
1e-3 of the largest entry; after one Adam step (|update| ~= lr for any
gradient well above eps) parameters agree to 1e-3 * lr, and to 2 * lr
where the gradient is within 100 eps of zero.
"""

import functools
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu import losses as jlosses  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu import render as jrender  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.config import with_defaults as j_defaults  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.data import dataset as jds  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.train import optim as joptim  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.train.trainer import (  # noqa: E402
    build_model as j_build_model,
)
from neuralvolumetricreconstructionformedicalimages_torch import losses as tlosses  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.config import (  # noqa: E402
    load_config,
    with_defaults as t_defaults,
)
from neuralvolumetricreconstructionformedicalimages_torch.models import params_from_jax  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.train import cli as tcli  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.train import optim as toptim  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as ttrainer  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.utils.logging import (  # noqa: E402
    ExperimentLogger,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "data", "smoke.pickle")


def _cfg(**over):
    cfg = {
        "exp": {"expname": "t", "expdir": ".", "datadir": SMOKE},
        "network": {"net_type": "mlp", "num_layers": 4, "hidden_dim": 16,
                    "skips": [2], "out_dim": 1, "last_activation": "sigmoid",
                    "bound": 0.3},
        # the main-path encoder at 3 levels x 2^14 (JAX's Pallas paths)
        "encoder": {"encoding": "hashgrid", "input_dim": 3, "num_levels": 3,
                    "level_dim": 2, "base_resolution": 8, "log2_hashmap_size": 14,
                    "forward": "sorted", "table_dtype": "bfloat16",
                    "pack_sort": True},
        "render": {"n_samples": 32, "n_fine": 0, "perturb": True,
                   "raw_noise_std": 0.0, "netchunk": 4096},
        "train": {"epoch": 2, "n_batch": 1, "n_rays": 64, "lrate": 1e-2,
                  "lrate_gamma": 0.1, "lrate_step": 10, "resume": False},
        "log": {"i_eval": 0, "i_save": 0},
    }
    for k, v in over.items():
        cfg[k].update(v)
    return cfg


def test_one_training_step_matches_jax():
    cfg_j, cfg_t = j_defaults(_cfg()), t_defaults(_cfg())
    spec = j_build_model(cfg_j)
    params = spec.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    params["encoder"]["table"] = jnp.asarray(
        0.1 * rng.normal(size=params["encoder"]["table"].shape).astype(np.float32))

    ds = jds.make_dataset(jds.load_pickle(SMOKE), "train", n_rays=64)
    key = jax.random.key(1)
    k_pix, k_render = jax.random.split(key)
    batch = jds.gather_view_batch(ds.arrays(), 5, k_pix, 64)
    loss_calc = jlosses.get_loss_fn("mse")

    def jloss(p):
        out = jrender.render_rays(batch["rays"], p["coarse"], spec, n_samples=32,
                                  perturb=True, key=k_render)
        return loss_calc(out["acc"], batch["projs"], None,
                         {"tv_loss": out["tv_loss"], "tv_density": out["tv_density"]})[0]

    jp = {"coarse": params}
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    opt = joptim.make_optimizer(cfg_j, 20)
    updates, _ = opt.update(jg, opt.init(jp), jp)
    jnew = optax.apply_updates(jp, updates)["coarse"]
    jg = jg["coarse"]

    field = ttrainer.build_model(cfg_t)
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    t_rand = torch.as_tensor(np.array(jax.random.uniform(
        jax.random.split(k_render, 4)[0], (64, 32), jnp.float32)))
    tbatch = {k: torch.as_tensor(np.array(batch[k])) for k in ("rays", "projs", "mask")}
    loss = ttrainer.make_loss_fn(cfg_t, use_mask=False)(field, None, tbatch,
                                                        t_rand=t_rand)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)

    def close(t, j, rel):
        j = np.asarray(j)
        np.testing.assert_allclose(t, j, rtol=0, atol=rel * np.abs(j).max())

    close(field.table.grad.numpy(), jg["encoder"]["table"], 1e-3)
    for i, lin in enumerate(field.layers):
        close(lin.weight.grad.numpy(), np.asarray(jg["layers"][i]["w"]).T, 1e-4)
        close(lin.bias.grad.numpy(), jg["layers"][i]["b"], 1e-4)

    tor = toptim.make_optimizer(cfg_t, field.parameters())
    toptim.set_lr(tor, toptim.make_lr_schedule(cfg_t, 20)(0))
    tor.step()
    lr = cfg_t["train"]["lrate"]

    def adam_close(t, j, g):
        # Adam moves an entry by lr * g / (|g| + 1e-8): entries whose gradient
        # is near eps move by a fraction of lr that the gradient's error sets.
        big = np.abs(np.asarray(g)) > 1e-6
        d = np.abs(t - np.asarray(j))
        assert d[big].max() <= 1e-3 * lr and d.max() <= 2 * lr

    adam_close(field.table.detach().numpy(), jnew["encoder"]["table"],
               jg["encoder"]["table"])
    for i, lin in enumerate(field.layers):
        adam_close(lin.weight.detach().numpy(), np.asarray(jnew["layers"][i]["w"]).T,
                   np.asarray(jg["layers"][i]["w"]).T)
        adam_close(lin.bias.detach().numpy(), jnew["layers"][i]["b"],
                   jg["layers"][i]["b"])


def test_lr_schedule_matches():
    cfg = _cfg(train={"lrate": 1e-3, "lrate_gamma": 0.5, "lrate_step": 3})
    js, ts = joptim.make_lr_schedule(cfg, 7), toptim.make_lr_schedule(cfg, 7)
    for step in (0, 1, 20, 21, 41, 42, 62, 63, 200):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)
    assert ts(20) == 1e-3 and ts(21) == 5e-4 and ts(62) == 2.5e-4


@pytest.mark.parametrize("name", ["mse", "l1", "huber", "hinge", "mse+small",
                                  "l1+tvd:0.05", "huber+zero+tv", "masked_mse+tvd"])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_registry_matches(name, masked):
    rng = np.random.default_rng(2)
    p, t = rng.normal(size=(2, 300)).astype(np.float32)
    t[:20] = 0.0
    m = (rng.uniform(size=300) > 0.3).astype(np.float32) if masked else None
    aux = {"tv_loss": 0.7, "tv_density": 0.3}
    jl, jc = jlosses.get_loss_fn(name)(jnp.asarray(p), jnp.asarray(t),
                                       None if m is None else jnp.asarray(m), aux)
    tl, tc = tlosses.get_loss_fn(name)(torch.as_tensor(p), torch.as_tensor(t),
                                       None if m is None else torch.as_tensor(m), aux)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(tc) == set(jc)
    with pytest.raises(NotImplementedError):
        tlosses.get_loss_fn("nope")


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The trainer logs JSONL only here (TensorBoard's import is slow)."""
    monkeypatch.setattr(ttrainer, "ExperimentLogger",
                        functools.partial(ExperimentLogger, enable_tensorboard=False))


def test_smoke_trainer_cpu(tmp_path, monkeypatch, no_tensorboard):
    """configs/smoke.yaml on the CPU: two epochs (0 and 1) of 20 steps at
    reduced rays/samples with evals, a falling loss, a checkpoint, resume."""
    monkeypatch.chdir(REPO)
    cfg = load_config("configs/smoke.yaml")
    cfg["train"].update(epoch=1, n_rays=128)
    cfg["render"]["n_samples"] = 32
    cfg["log"].update(i_eval=1, i_save=1)
    tr = ttrainer.Trainer(cfg, workdir=str(tmp_path), device="cpu")
    tr.start()
    losses = np.asarray(tr.losses)
    assert losses.shape == (40,) and np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()
    assert len(tr.step_ms) == 40 and tr.global_step == 40
    assert set(tr.eval_metrics) == {0, 1}
    assert np.isfinite(tr.eval_metrics[1]["psnr_3d"])
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_000001.pt"]
    assert (tmp_path / "eval" / "epoch_00001" / "stats.txt").exists()

    cfg["train"].update(epoch=2, resume=True)
    cfg["log"]["i_eval"] = 0
    tr2 = ttrainer.Trainer(cfg, workdir=str(tmp_path), device="cpu")
    assert tr2.epoch_start == 2 and tr2.global_step == 40
    for a, b in zip(tr2.field.parameters(), tr.field.parameters()):
        assert torch.equal(a, b)
    tr2.start()
    assert len(tr2.losses) == 20 and np.isfinite(tr2.losses).all()
    tr2.save(3)
    tr2.save(4)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_000003.pt", "ckpt_000004.pt"]


def test_cli_runs_on_cpu(tmp_path, monkeypatch, no_tensorboard):
    monkeypatch.chdir(REPO)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"inherit_from: {os.path.join(REPO, 'configs', 'smoke.yaml')}\n"
                   "train:\n  epoch: 0\n  n_rays: 64\n"
                   "render:\n  n_samples: 16\nlog:\n  i_eval: 0\n  i_save: 0\n")
    tcli.main(["--config", str(cfg), "--workdir", str(tmp_path / "run"),
               "--device", "cpu"])
    assert (tmp_path / "run" / "metrics.jsonl").exists()


def test_trainer_without_device_needs_a_card(monkeypatch):
    """``device=None`` means the card; without one the trainer raises
    instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.Trainer(t_defaults(_cfg()))
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.resolve_device("cuda")
    assert ttrainer.resolve_device("cpu") == torch.device("cpu")
