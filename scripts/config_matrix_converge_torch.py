#!/usr/bin/env python3
"""Converged quality runs of the non-chest configuration classes on the card.

Trains each variant of the reference's CT configs to convergence on a
smoothed Shepp-Logan phantom (the sharpness class of real CT volumes; PSNR
on a binary-edge phantom measures sub-voxel sharpness, not fidelity):

- abdomen: n_samples 576, sigmoid, 240 epochs;
- foot:    n_samples 320, last_activation tanh, 320 epochs;
- jaw:     n_samples 320, last_activation none, a beam mask (a 2-D
           ``full_proj``, see ``config_matrix_smoke_torch.beam_full_proj``),
           320 epochs.

Each variant reads the bundled ``data/<name>_smooth.pickle``.  Only when
that file is missing is the scan made (``--gen``: the port's generator at
seed 7, a sigma = 1 voxel ``scipy.ndimage.gaussian_filter`` of its image,
the views reprojected on the card), into ``data/<name>_smooth_torch.pickle``.

Each variant runs in a process of its own (``sys.executable``) through the
port's ``Trainer`` from ``configs/chest_50.yaml`` (the chest_50 model at
full width, 1024 rays a step) with the variant's ``n_samples`` and
``last_activation``, the JAX script's ``lrate_step`` (which, read in
epochs, never decays the rate), an eval every 40 epochs, and stops
between epochs once its deadline has passed.  It writes
``docs/config_matrix_torch/converge/<name>.json`` (every eval with its
step, the final eval, the median step time), ``metrics_<name>.jsonl`` and
the last eval's images.

    python3 scripts/config_matrix_converge_torch.py [--deadline SEC] [--device cpu]
    python3 scripts/config_matrix_converge_torch.py --child NAME DEADLINE [--device cpu]
    python3 scripts/config_matrix_converge_torch.py --gen NAME [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import config_matrix_smoke_torch as smoke  # noqa: E402
import make_smooth_phantom_torch as smooth  # noqa: E402

OUTDIR = "docs/config_matrix_torch/converge"
SCAN = smoke.SCAN

# epochs x 50 steps an epoch x 1024 rays; abdomen (1.8x the points a step
# of foot and jaw) gets a 240-epoch schedule
VARIANTS = {
    "foot": dict(n_samples=320, last_activation="tanh", mask=False, epochs=320),
    "jaw": dict(n_samples=320, last_activation="none", mask=True, epochs=320),
    "abdomen": dict(n_samples=576, last_activation="sigmoid", mask=False, epochs=240),
}


def smooth_data(masked: bool, device=None, scan: Dict[str, Any] = SCAN) -> Dict[str, Any]:
    """The Shepp-Logan scan of ``scan`` (seed 7) with its image blurred by
    a 1-voxel Gaussian and its views reprojected on ``device`` (the card by
    default; ``make_smooth_phantom_torch.smooth_phantom``); with the beam's
    ``full_proj`` when ``masked``."""
    from neuralvolumetricreconstructionformedicalimages_torch.data.generate import generate
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        resolve_device)

    dev = resolve_device(device)
    data = smooth.smooth_phantom(generate(scan, phantom="shepp_logan", seed=7, device=dev), dev)
    if masked:
        data["full_proj"] = smoke.beam_full_proj(scan)
    return data


def data_path(name: str) -> str:
    """The bundled ``data/<name>_smooth.pickle`` when present, else the
    port's own ``data/<name>_smooth_torch.pickle``."""
    tracked = f"data/{name}_smooth.pickle"
    return tracked if os.path.exists(tracked) else f"data/{name}_smooth_torch.pickle"


def make_data(name: str, device=None) -> str:
    """The variant's dataset path; the port's own file is made if neither
    it nor the bundled one exists (the bundled name is never written)."""
    from neuralvolumetricreconstructionformedicalimages_torch.data.generate import save

    path = data_path(name)
    if not os.path.exists(path):
        save(smooth_data(VARIANTS[name]["mask"], device), path)
    return path


def variant_cfg(name: str, path: str) -> Dict[str, Any]:
    """The converge run's config of variant ``name`` on ``path``."""
    v = VARIANTS[name]
    cfg = smoke.variant_cfg(v, f"{name}_converge_torch", path)
    # ``lrate_step`` as the JAX script sets it, 70 % of the schedule's
    # steps; the schedule reads it in epochs, so the rate never decays in
    # these runs (the JAX runs' logged rate stays 1e-3 too)
    cfg["train"].update(epoch=v["epochs"], resume=False,
                        lrate_step=int(v["epochs"] * 50 * 0.7))
    cfg["log"].update(i_eval=40, i_save=0)
    return cfg


def child(name: str, deadline_s: float, device=None) -> None:
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import Trainer

    v = VARIANTS[name]
    path = make_data(name, device)
    workdir = f"logs/{name}_converge_torch"
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.time()
    tr = Trainer(variant_cfg(name, path), workdir=workdir, device=device)
    if tr.use_mask != v["mask"]:
        raise AssertionError(f"{name}: use_mask {tr.use_mask}, want {v['mask']}")
    tr.start(deadline=time.time() + deadline_s)
    metrics = tr.eval_step(tr.global_step, tr.last_epoch)
    wall = time.time() - t0
    evals = [{"epoch": e, "step": e * tr.steps_per_epoch, **m}
             for e, m in sorted(tr.eval_metrics.items())]
    rec = {
        "datadir": path, "n_samples": v["n_samples"],
        "last_activation": v["last_activation"], "masked": v["mask"],
        "epochs_target": v["epochs"], "epochs_done": int(tr.last_epoch),
        "steps_done": int(tr.global_step), "wall_s": wall,
        "median_step_ms": float(np.median(tr.step_ms)),
        "evals": evals,
        **{k: float(x) for k, x in metrics.items()},
    }
    os.makedirs(OUTDIR, exist_ok=True)
    with open(os.path.join(OUTDIR, f"{name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    src = os.path.join(workdir, "metrics.jsonl")
    if os.path.exists(src):
        shutil.copy(src, os.path.join(OUTDIR, f"metrics_{name}.jsonl"))
    evald = os.path.join(workdir, "eval")
    if os.path.isdir(evald) and os.listdir(evald):
        last = os.path.join(evald, sorted(os.listdir(evald))[-1])
        for fn in os.listdir(last):
            if fn.endswith((".png", ".txt")):
                shutil.copy(os.path.join(last, fn), os.path.join(OUTDIR, f"{name}_{fn}"))
    print("[converge] " + json.dumps({name: {k: x for k, x in rec.items() if k != "evals"}}),
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--deadline", type=float, default=4800.0, help="seconds for all")
    p.add_argument("--child", nargs=2, metavar=("NAME", "DEADLINE"), default=None)
    p.add_argument("--gen", choices=sorted(VARIANTS), default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    if args.gen:
        print(f"[converge] {args.gen}: {make_data(args.gen, args.device)}")
        return 0
    if args.child:
        child(args.child[0], float(args.child[1]), args.device)
        return 0
    t_end = time.time() + args.deadline
    os.makedirs(OUTDIR, exist_ok=True)
    dev = [] if args.device is None else ["--device", args.device]
    for name in VARIANTS:
        remaining = t_end - time.time()
        if remaining < 300:
            print(f"[converge] deadline: skipping {name}", flush=True)
            continue
        budget = min(remaining - 60, 2100.0)
        print(f"[converge] {time.strftime('%H:%M:%S')} spawn {name} "
              f"(budget {budget:.0f} s)", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", name,
                        str(budget), *dev], cwd=ROOT, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
