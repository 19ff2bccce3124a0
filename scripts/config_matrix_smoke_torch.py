#!/usr/bin/env python3
"""Smokes of the non-chest configuration classes on the card.

The reference's abdomen, foot and jaw CT scans are external downloads that
the repository does not hold, so each variant trains on a generated
Shepp-Logan scan (the port's ``data/generate.py``, seed 7) at the workload
envelope of its reference config:

- abdomen: n_samples 576 (589,824 point queries a step, the largest);
- foot:    n_samples 320, last_activation tanh;
- jaw:     n_samples 320, a beam mask (a 2-D ``full_proj`` that is 0.05
           inside a circle of 0.45 x the detector height and 0 outside, so
           the mask drops the corners), last_activation none.

Each variant starts from ``configs/chest_50.yaml`` (the chest_50 model at
full width, 1024 rays a step), overrides ``n_samples``,
``last_activation``, ``expname``, ``datadir``, ``epoch``, ``resume`` and
``log``, trains 40 epochs through the port's ``Trainer`` with evals, and
writes its figures to ``docs/config_matrix_torch/smoke/<name>.json``.
Training stops between epochs once the deadline has passed.

    python3 scripts/config_matrix_smoke_torch.py [NAME] [--deadline SEC] [--device cpu]

The scans go to ``data/<name>_smoke.pickle``.  Runs on the card unless
``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTDIR = "docs/config_matrix_torch/smoke"

SCAN = dict(nVoxel=[128, 128, 128], dVoxel=[1.0, 1.0, 1.0],
            nDetector=[256, 256], dDetector=[1.0, 1.0],
            numTrain=50, numVal=10, mode="cone", totalAngle=180)

VARIANTS = {
    "abdomen": dict(n_samples=576, last_activation="sigmoid", mask=False, epochs=40),
    "foot": dict(n_samples=320, last_activation="tanh", mask=False, epochs=40),
    "jaw": dict(n_samples=320, last_activation="none", mask=True, epochs=40),
}


def beam_full_proj(scan: Dict[str, Any]) -> np.ndarray:
    """A synthetic circular beam as one 2-D ``full_proj`` shared by every
    view: 0.05 (above the mask threshold) inside a circle of 0.45 x the
    detector height about the detector's centre, 0 outside."""
    H, W = scan["nDetector"][1], scan["nDetector"][0]
    yy, xx = np.mgrid[0:H, 0:W]
    beam = (np.hypot(yy - H / 2, xx - W / 2) < 0.45 * H).astype(np.float32)
    return 0.05 * beam


def smoke_data(masked: bool, device=None, scan: Dict[str, Any] = SCAN) -> Dict[str, Any]:
    """The Shepp-Logan scan of ``scan`` (seed 7, projected on ``device``,
    the card by default), with the beam's ``full_proj`` when ``masked``."""
    from neuralvolumetricreconstructionformedicalimages_torch.data.generate import generate

    data = generate(scan, phantom="shepp_logan", seed=7, device=device)
    if masked:
        data["full_proj"] = beam_full_proj(scan)
    return data


def variant_cfg(variant: Dict[str, Any], expname: str, datadir: str) -> Dict[str, Any]:
    """``configs/chest_50.yaml`` with a variant's ``n_samples``,
    ``last_activation`` and epochs (no resume, an eval halfway, no
    checkpoints), named ``expname``, on ``datadir``."""
    from neuralvolumetricreconstructionformedicalimages_torch.config import (
        load_config, with_defaults)

    cfg = with_defaults(load_config("configs/chest_50.yaml"))
    cfg["exp"].update(expname=expname, datadir=datadir)
    cfg["render"]["n_samples"] = variant["n_samples"]
    cfg["network"]["last_activation"] = variant["last_activation"]
    cfg["train"].update(epoch=variant["epochs"], resume=False)
    cfg["log"].update(i_eval=variant["epochs"] // 2, i_save=0)
    return cfg


def make_data(name: str, masked: bool, device=None) -> str:
    """``data/<name>_smoke.pickle``, made if missing."""
    from neuralvolumetricreconstructionformedicalimages_torch.data.generate import save

    path = f"data/{name}_smoke.pickle"
    if not os.path.exists(path):
        save(smoke_data(masked, device), path)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("only", nargs="?", choices=sorted(VARIANTS), default=None)
    p.add_argument("--deadline", type=float, default=1200.0, help="seconds")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import Trainer

    os.makedirs(OUTDIR, exist_ok=True)
    t_end = time.time() + args.deadline
    results = {}
    for name, v in VARIANTS.items():
        if args.only and name != args.only:
            continue
        if time.time() > t_end - 120:
            print(f"[smoke] deadline: skipping {name}", flush=True)
            break
        path = make_data(name, v["mask"], args.device)
        cfg = variant_cfg(v, f"{name}_smoke", path)
        print(f"[smoke] {time.strftime('%H:%M:%S')} {name}: n_samples={v['n_samples']} "
              f"act={v['last_activation']} mask={v['mask']}", flush=True)
        t0 = time.time()
        tr = Trainer(cfg, workdir=f"logs/{name}_smoke", device=args.device)
        if tr.use_mask != v["mask"]:
            raise AssertionError(f"{name}: use_mask {tr.use_mask}, want {v['mask']}")
        tr.start(deadline=t_end)
        metrics = tr.eval_step(tr.global_step, tr.last_epoch)
        wall = time.time() - t0
        results[name] = {
            "n_samples": v["n_samples"], "last_activation": v["last_activation"],
            "masked": v["mask"], "epochs": v["epochs"],
            "steps_done": int(tr.global_step), "wall_s": wall,
            "median_step_ms": float(np.median(tr.step_ms)),
            **{k: float(x) for k, x in metrics.items()},
        }
        print("[smoke] " + json.dumps({name: results[name]}), flush=True)
        with open(os.path.join(OUTDIR, f"{name}.json"), "w") as f:
            json.dump(results[name], f, indent=1)
    print(json.dumps(results, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
