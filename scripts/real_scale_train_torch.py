#!/usr/bin/env python3
"""A short training run at the real laminography scan's shape.

The port of ``scripts/real_scale_train.py``: 187 views x 1024^2
complex-phase projections at the measured angles of
``data/angles_real.npy`` (tilted-axis parallel beam), trained through the
production path -- rays on the fly, the beam mask from ``full_proj``, the
masked eval (``log.eval_mask``).

The complex stack is synthesised: the lamino-chip phantom (256 x 256 x 64,
unsmoothed) is projected at 256^2 over the same physical detector (4 mm
pixels: 256 x 4 mm = 1024 x 1 mm) on the card, zoomed to 1024^2
(``scipy.ndimage.zoom``, order 1), and its line integrals, scaled to [0, 2]
rad, become the phase of a unit-amplitude field behind a circular beam
(``real_scale_train_r5_torch.complex_scan``: the real scan's formatter).

The port's ``Trainer`` trains ``configs/chest_50.yaml`` (the chest_50 model
at full width) at ``NVR_RS_RAYS`` rays a step (default 1024) for
``NVR_RS_EPOCHS`` epochs (default 12; 187 steps each, epochs 0..N) with an
eval at epoch 0 and at the end, and writes ``docs/real_scale_torch/train/``
(``result.json``, ``metrics.jsonl``, ``stats.txt``, the eval PNGs) and its
logs under ``logs/``.  The projected stack is cached in the temporary
directory (``nvr_realscale_gen_torch.npz``).

    python3 scripts/real_scale_train_torch.py [--out DIR] [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import real_scale_train_r5_torch as r5  # noqa: E402

N_VIEWS, H, W = r5.N_VIEWS, r5.H, r5.W
LO = 256                      # the projected detector's side
OUTDIR = "docs/real_scale_torch/train"
WORKDIR = "logs/real_scale_train_torch"
GEN_NPZ = os.path.join(tempfile.gettempdir(), "nvr_realscale_gen_torch.npz")


def upsampled_stack(angles_deg: np.ndarray, device=None, lo: int = LO, det: int = H):
    """The lamino-chip phantom (256 x 256 x 64) projected at ``lo``^2 over
    the physical detector of ``det``^2 1 mm pixels (``det / lo`` mm
    pixels), then zoomed to ``det``^2 (order 1): ([n, det, det] f32, the
    volume)."""
    from scipy.ndimage import zoom

    from neuralvolumetricreconstructionformedicalimages_torch.data.phantoms import (
        get_phantom)
    shape = (256, 256, 64)
    vol = get_phantom("lamino_chip", shape).astype(np.float32)
    geo_lo = r5.chip_geometry(shape, (lo, lo), pixel=0.001 * det / lo)
    proj_lo = r5.project(vol, geo_lo, angles_deg, device)
    proj = zoom(proj_lo, (1, det / lo, det / lo), order=1).astype(np.float32)
    return proj, vol


def make_data(proj: np.ndarray, vol: np.ndarray, angles_deg: np.ndarray
              ) -> Dict[str, Any]:
    """The dataset dict: the phase is the line integral scaled to [0, 2]
    rad (non-negative, as the renderer's Beer-Lambert sum is)."""
    phase = proj / max(1e-6, proj.max()) * 2.0
    return r5.complex_scan(phase, vol, angles_deg)


def run_cfg(epochs: int, n_rays: int) -> Dict[str, Any]:
    """``configs/chest_50.yaml`` with the JAX script's overrides: an eval
    at epoch 0 and at the last epoch."""
    from neuralvolumetricreconstructionformedicalimages_torch.config import (
        load_config, with_defaults)
    cfg = with_defaults(load_config("configs/chest_50.yaml"))
    cfg["exp"].update(expname="real_scale_train_r4", datadir="(in-memory)")
    cfg["train"].update(epoch=epochs, resume=False, lrate=1e-3, n_rays=n_rays)
    cfg["log"].update(i_eval=epochs, i_save=0, eval_mask=True)
    return cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=OUTDIR)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        resolve_device)

    epochs = int(os.environ.get("NVR_RS_EPOCHS", 12))
    n_rays = int(os.environ.get("NVR_RS_RAYS", 1024))
    dev = resolve_device(args.device)
    angles_deg = r5.real_angles_deg()
    if os.path.exists(GEN_NPZ):
        d = np.load(GEN_NPZ)
        proj, vol, gen_s = d["proj"], d["vol"], float(d["generate_s"])
    else:
        t0 = time.perf_counter()
        proj, vol = upsampled_stack(angles_deg, dev)
        gen_s = time.perf_counter() - t0
        np.savez(GEN_NPZ, proj=proj, vol=vol, generate_s=gen_s)
    print(f"[gen] {proj.shape} in {gen_s:.1f} s, range [{proj.min():.3f}, "
          f"{proj.max():.3f}]", flush=True)
    data = make_data(proj, vol, angles_deg)
    del proj

    shutil.rmtree(WORKDIR, ignore_errors=True)
    tr = r5.in_memory_trainer(run_cfg(epochs, n_rays), data, WORKDIR, dev)
    print(f"ray_mode={tr.train_dset.ray_mode} use_mask={tr.use_mask} "
          f"steps/epoch={tr.steps_per_epoch}", flush=True)
    assert tr.train_dset.ray_mode == "onthefly"
    assert tr.use_mask, "beam mask must be active"

    t0 = time.time()
    tr.start()
    wall = time.time() - t0
    step_ms = float(np.median(tr.step_ms))
    print(f"trained {epochs + 1} epochs in {wall:.0f}s, median step {step_ms:.3f} "
          f"ms ({tr.n_rays / (step_ms / 1e3):,.0f} rays/s), evals included",
          flush=True)
    final = tr.eval_metrics[max(tr.eval_metrics)]
    rec = {
        "views": N_VIEWS, "detector": [H, W], "projected_at": [LO, LO],
        "n_rays": tr.n_rays, "epochs_done": int(tr.last_epoch),
        "steps_done": int(tr.global_step), "train_wall_s": wall,
        "median_step_ms": step_ms, "rays_s": tr.n_rays / (step_ms / 1e3),
        "generate_s": gen_s, "card": r5.card_line(dev),
        "evals": {int(e): m for e, m in sorted(tr.eval_metrics.items())},
        **{k: float(v) for k, v in final.items()},
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(rec, f, indent=1)
    r5.copy_eval(WORKDIR, args.out)
    print("[result] " + json.dumps(rec), flush=True)
    print("REAL-SCALE TRAIN DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
