#!/usr/bin/env python3
"""Converged real-scale laminography run at the native 1024^2 detector.

The port of ``scripts/real_scale_train_r5.py``: the reference's real-scan
shape (187 views of 1024^2 at the measured angles of
``data/angles_real.npy``, a tilted-axis parallel beam) trained through the
production complex-phase pipeline to a final masked eval.

- The volume is the lamino-chip phantom (256 x 256 x 64) smoothed by one
  voxel; its 187 views are projected at 320 samples a ray on the card by
  ``data/projector.py::project_angles`` (about 43 s).  The largest
  difference between that stack and ``project_angles_parallel_cpu`` (the
  host projector the JAX run's stack came from) on views 0, 93 and 186 is
  printed and recorded.
- :func:`make_data` turns the stack into a unit-amplitude complex field
  whose phase is the scaled line integral, behind a circular beam, and
  formats it with ``data/format_real.py`` (the real scan's formatter).
- :func:`run_cfg` is ``configs/chest_50.yaml`` (the chest_50 model at full
  width) at ``n_rays`` rays a step (``NVR_RS_RAYS``, default 4096) for
  ``--epochs`` epochs (default 400; the loop runs epochs 0..N, 187 steps
  each), with the JAX run's ``lrate_step`` (``epochs * 187``, read in
  epochs, so the rate never decays) and ``eval_mask``.
- The port's ``Trainer`` runs on the in-memory datasets (rays on the fly,
  the beam mask), stops between epochs once ``NVR_RS_BUDGET_S`` (default
  2400) has passed, and ends with one masked eval: projection PSNR on a
  val view and the 3D PSNR/SSIM of the recovered volume against the
  phantom.

Writes ``docs/real_scale_torch/train_r5/`` (``result.json``,
``metrics.jsonl``, ``stats.txt``, the eval PNGs; ``--out`` moves it) and
the trainer's logs under ``logs/``.  The projected stack is cached in the
temporary directory (``nvr_realscale_gen_torch_r5.npz``) for a later run.

    python3 scripts/real_scale_train_r5_torch.py [--epochs 400] [--out DIR]
        [--device cpu]

``--epochs 50`` stops at the JAX run's 9,537 steps.  Runs on the card
unless ``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_VIEWS, H, W = 187, 1024, 1024
GEN_SAMPLES = 320             # samples a ray of the projector
CHECK_VIEWS = (0, 93, 186)    # views held against the host projector
OUTDIR = "docs/real_scale_torch/train_r5"
WORKDIR = "logs/real_scale_train_r5_torch"
GEN_NPZ = os.path.join(tempfile.gettempdir(), "nvr_realscale_gen_torch_r5.npz")


def real_angles_deg(n_views: int = N_VIEWS) -> np.ndarray:
    """The first ``n_views`` measured angles, in degrees (f64)."""
    return np.rad2deg(np.load("data/angles_real.npy").astype(np.float64))[:n_views]


def chip_geometry(shape=(256, 256, 64), detector=(W, H), pixel: float = 0.001):
    """The scan's tilted-axis parallel geometry: 1.5 mm voxels, 29 degrees
    of tilt, ``pixel`` metres a detector pixel."""
    from neuralvolumetricreconstructionformedicalimages_torch import geometry as G

    return G.ConeGeometry(
        DSD=1.5, DSO=1.0, nDetector=tuple(detector), dDetector=(pixel, pixel),
        nVoxel=tuple(shape), dVoxel=(0.0015, 0.0015, 0.0015),
        mode="parallel", tilt_angle=29.0)


def gen_geo_vol(shape=(256, 256, 64), detector=(W, H)):
    """The geometry and the lamino-chip phantom smoothed by one voxel
    (the realistic sharpness class)."""
    from scipy.ndimage import gaussian_filter

    from neuralvolumetricreconstructionformedicalimages_torch.data.phantoms import (
        get_phantom)
    vol = gaussian_filter(get_phantom("lamino_chip", shape).astype(np.float32), 1.0)
    return chip_geometry(shape, detector), vol


def project(vol: np.ndarray, geo, angles_deg: np.ndarray, device=None) -> np.ndarray:
    """The views of ``vol`` at ``angles_deg`` on ``device`` (the card by
    default), ``GEN_SAMPLES`` samples a ray: [n, H, W] f32 on the host."""
    from neuralvolumetricreconstructionformedicalimages_torch.data.projector import (
        project_angles)
    angles = np.deg2rad(angles_deg).astype(np.float32)
    return project_angles(vol, geo, angles, GEN_SAMPLES, device=device).cpu().numpy()


def projector_check(proj: np.ndarray, vol: np.ndarray, geo, angles_deg: np.ndarray,
                    views=CHECK_VIEWS) -> Dict[str, Any]:
    """The largest difference between ``proj`` and the host projector
    (``project_angles_parallel_cpu``, the function the JAX run's stack came
    from) on ``views``."""
    from neuralvolumetricreconstructionformedicalimages_torch.data.projector import (
        project_angles_parallel_cpu)
    views = list(views)
    t0 = time.perf_counter()
    ref = project_angles_parallel_cpu(
        vol, geo, np.deg2rad(angles_deg[views]).astype(np.float32), GEN_SAMPLES)
    diff = np.abs(proj[views] - ref)
    return {"views": views, "max_abs_diff": float(diff.max()),
            "max_value": float(np.abs(ref).max()),
            "pixels_over_1e-4": int((diff > 1e-4).sum()), "pixels": int(diff.size),
            "host_s": time.perf_counter() - t0}


def complex_scan(phase: np.ndarray, vol: np.ndarray, angles_deg: np.ndarray
                 ) -> Dict[str, Any]:
    """A unit-amplitude complex field of ``phase`` behind a circular beam
    (radius 0.48 of the detector: zero amplitude outside, the ptycho mask),
    formatted as the real scan is (the formatter's rot90 undone first), on
    the phantom's grid with the phantom as ground truth."""
    from neuralvolumetricreconstructionformedicalimages_torch.data.format_real import (
        format_real_data)
    h, w = phase.shape[1:]
    yy, xx = np.mgrid[0:h, 0:w]
    beam = (np.hypot(yy - h / 2, xx - w / 2) < 0.48 * h).astype(np.float32)
    cplx = (beam * np.exp(1j * phase)).astype(np.complex64)
    data = format_real_data(np.rot90(cplx, k=-1, axes=(1, 2)), angles_deg,
                            tilt_angle=29.0, n_slices=64)
    data.update(nVoxel=list(vol.shape), dVoxel=[1.5, 1.5, 1.5],
                offOrigin=[0, 0, 0], image=vol)
    return data


def make_data(proj: np.ndarray, vol: np.ndarray, angles_deg: np.ndarray
              ) -> Dict[str, Any]:
    """The dataset dict of the projected stack ``proj`` [n, H, W] (the JAX
    script's lines 150-158, with the grid taken from ``vol``: the JAX
    script's 256 x 256 x 64 at the real size).

    The phase is the line integral scaled so that the density the field
    must fit, ``phase_max / max(proj) * vol``, stays inside the sigmoid's
    range: ``phase_max`` = 0.9 * max(proj) / max(vol)."""
    phase_max = 0.9 * float(proj.max()) / max(1e-6, float(vol.max()))
    phase = proj / max(1e-6, proj.max()) * phase_max
    return complex_scan(phase, vol, angles_deg)


def run_cfg(epochs: int, n_rays: int) -> Dict[str, Any]:
    """``configs/chest_50.yaml`` with the JAX run's overrides.

    ``lrate_step`` is ``epochs * 187`` as there; the schedule reads it in
    epochs, so the rate stays at 1e-3, in both runs alike."""
    from neuralvolumetricreconstructionformedicalimages_torch.config import (
        load_config, with_defaults)
    cfg = with_defaults(load_config("configs/chest_50.yaml"))
    cfg["exp"].update(expname="real_scale_train_r5", datadir="(in-memory)")
    cfg["train"].update(epoch=epochs, resume=False, lrate=1e-3,
                        n_rays=n_rays, lrate_step=epochs * 187)
    cfg["log"].update(i_eval=0, i_save=0, eval_mask=True)
    return cfg


def in_memory_trainer(cfg: Dict[str, Any], data: Dict[str, Any], workdir: str,
                      device=None):
    """The port's ``Trainer`` on the datasets of ``data`` (no pickle): its
    loader reads the dict while the trainer is built; the val dataset is
    built too when the trainer did not (it does only when ``i_eval`` > 0),
    for the final eval."""
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        make_dataset)
    from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as T

    saved = T.load_dataset
    T.load_dataset = lambda path, split, n_rays, **kw: make_dataset(
        data, split, n_rays=n_rays, **kw)
    try:
        tr = T.Trainer(cfg, workdir=workdir, device=device)
    finally:
        T.load_dataset = saved
    if tr.eval_dset is None:
        tr.eval_dset = make_dataset(data, "val", n_rays=tr.n_rays, device=tr.device)
    return tr


def card_line(dev) -> str:
    """The card's name and power limit (``nvidia-smi``) when ``dev`` (a
    device or its name) is a card, else ``CPU``."""
    if not str(dev).startswith("cuda"):
        return "CPU"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def copy_eval_files(src: str, outdir: str, prefix: str = "") -> None:
    """An eval directory's stats and images into ``outdir``, each name
    given ``prefix``."""
    for f in ("stats.txt", "proj_show_left_gt_right_pred.png",
              "slice_show_row1_gt_row2_pred.png"):
        if os.path.exists(os.path.join(src, f)):
            shutil.copy(os.path.join(src, f), os.path.join(outdir, prefix + f))


def copy_eval(workdir: str, outdir: str) -> None:
    """``metrics.jsonl`` and the last eval's stats and images into ``outdir``."""
    shutil.copy(os.path.join(workdir, "metrics.jsonl"),
                os.path.join(outdir, "metrics.jsonl"))
    evals = sorted(os.listdir(os.path.join(workdir, "eval")))
    if evals:
        copy_eval_files(os.path.join(workdir, "eval", evals[-1]), outdir)


def scan(dev) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]]:
    """The projected stack, the volume and the angles (from the cache when
    it holds them), and the projector's figures."""
    if os.path.exists(GEN_NPZ):
        d = np.load(GEN_NPZ)
        print(f"[gen] read {GEN_NPZ}", flush=True)
        return d["proj"], d["vol"], d["angles_deg"], json.loads(str(d["gen"]))
    angles_deg = real_angles_deg()
    geo, vol = gen_geo_vol()
    project(vol, geo, angles_deg[:1], dev)                  # warm-up
    t0 = time.perf_counter()
    proj = project(vol, geo, angles_deg, dev)
    gen = {"generate_s": time.perf_counter() - t0, "device": str(dev)}
    print(f"[gen] {proj.shape} on {dev} in {gen['generate_s']:.1f} s, range "
          f"[{proj.min():.3f}, {proj.max():.3f}]", flush=True)
    gen["projector_check"] = projector_check(proj, vol, geo, angles_deg)
    print(f"[gen] against project_angles_parallel_cpu: {gen['projector_check']}",
          flush=True)
    np.savez(GEN_NPZ, proj=proj, vol=vol, angles_deg=angles_deg, gen=json.dumps(gen))
    return proj, vol, angles_deg, gen


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--out", default=OUTDIR)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        resolve_device)

    budget_s = float(os.environ.get("NVR_RS_BUDGET_S", 2400))
    n_rays = int(os.environ.get("NVR_RS_RAYS", 4096))
    dev = resolve_device(args.device)
    proj, vol, angles_deg, gen = scan(dev)
    t0 = time.perf_counter()
    data = make_data(proj, vol, angles_deg)
    format_s = time.perf_counter() - t0
    del proj

    cfg = run_cfg(args.epochs, n_rays)
    shutil.rmtree(WORKDIR, ignore_errors=True)
    tr = in_memory_trainer(cfg, data, WORKDIR, dev)
    print(f"ray_mode={tr.train_dset.ray_mode} use_mask={tr.use_mask} "
          f"steps/epoch={tr.steps_per_epoch} n_rays={tr.n_rays} "
          f"format {format_s:.1f} s", flush=True)
    assert tr.train_dset.ray_mode == "onthefly"
    assert tr.use_mask, "beam mask must be active"

    t0 = time.time()
    tr.start(deadline=time.time() + budget_s)
    wall = time.time() - t0
    print("[eval] final masked eval + dense 3D metrics...", flush=True)
    t0 = time.perf_counter()
    metrics = tr.eval_step(tr.global_step, tr.last_epoch)
    eval_s = time.perf_counter() - t0
    step_ms = float(np.median(tr.step_ms))
    rec = {
        "views": N_VIEWS, "detector": [H, W], "native_resolution": True,
        "n_rays": tr.n_rays, "seed": int(cfg["train"].get("seed", 42)),
        "epochs_done": int(tr.last_epoch), "steps_done": int(tr.global_step),
        "train_wall_s": wall, "median_step_ms": step_ms,
        "rays_s": tr.n_rays / (step_ms / 1e3), "eval_s": eval_s,
        "format_s": format_s, **gen, "card": card_line(dev),
        **{k: float(v) for k, v in metrics.items()},
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(rec, f, indent=1)
    copy_eval(WORKDIR, args.out)
    print("[result] " + json.dumps(rec), flush=True)
    print("REAL-SCALE R5 DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
