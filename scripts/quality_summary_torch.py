#!/usr/bin/env python3
"""The chest-phantom quality study: train its configs on the card and
collect them into tables, the port's runs beside the JAX package's.

The port of ``scripts/quality_summary.py``, with the same runs and the same
reading of each run's log (peak and final ``eval/psnr_3d``, final
``eval/ssim_3d``: :func:`summarize`):

- ``docs/quality_attribution_torch/``: the attribution runs of ``RUNS``
  (50, 100 and 200 views, 200 views at bound 0.1, density TV, the smoothed
  phantom);
- ``docs/quality_chest_torch/``: r3, full (bound 0.065), best (bound 0.1
  with StepLR at 300) and r3 resumed by consolidate (StepLR at 400) and
  then finetune (256 samples).

Each directory gets a ``README.md`` with the table, every run's
``metrics_<config>.jsonl`` and its last eval's ``.txt`` and ``.png``
(``<config>_<file>``).  The JAX figures are read from the JAX runs'
committed logs (``JAX_METRICS``).  No quality gate: the JAX runs predate
the ray-precision fix.

The port's logs are ``train_full_torch.py``'s: ``logs/full/<expname>/
metrics_<config>.jsonl`` (consolidate and finetune keep r3's expname, so
their logs hold r3's records too, as the JAX run's
``metrics_consolidate.jsonl`` does).

    python3 scripts/quality_summary_torch.py [--train]

``--train`` first trains ``STUDY`` in order through
``scripts/train_full_torch.py``, making the smoothed and view-sweep
datasets where they are missing.  The runs are the card's, and the tables
name it: without a card the script raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from real_scale_train_r5_torch import copy_eval_files

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = os.path.join("logs", "full")
RUNS = [
    ("chest_phantom_r3", "50 views (r3)"),
    ("chest_phantom_views100", "100 views, same phantom+val"),
    ("chest_phantom_views200", "200 views, same phantom+val"),
    ("chest_phantom_views200_b01", "200 views + bound 0.1 (capacity probe)"),
    ("chest_phantom_tvd", "50 views + density-TV 0.1"),
    ("chest_phantom_smooth", "50 views, smoothed (real-CT-like) phantom"),
]
CHEST_RUNS = [
    ("chest_phantom_r3", "r3: reference defaults (bound 0.3), 400 epochs"),
    ("chest_phantom_full", "full: bound 0.065, 1000 epochs"),
    ("chest_phantom_best", "best: bound 0.1 + StepLR at 300, 800 epochs"),
    ("chest_phantom_consolidate", "r3 resumed at epoch 400: StepLR at 400, to 700"),
    ("chest_phantom_finetune", "then resumed at 700: n_samples 256, to 800"),
]
# the configs of the study, in the order they train (consolidate and
# finetune resume r3's directory)
STUDY = ("chest_phantom_r3", "chest_phantom_consolidate", "chest_phantom_finetune",
         "chest_phantom_full", "chest_phantom_best", "chest_phantom_views100",
         "chest_phantom_views200", "chest_phantom_views200_b01", "chest_phantom_tvd",
         "chest_phantom_smooth")
OUT_ATTRIBUTION = "docs/quality_attribution_torch"
OUT_CHEST = "docs/quality_chest_torch"
# the JAX runs' committed logs, by config
JAX_METRICS = {
    "chest_phantom_r3": "docs/quality_chest_r3/metrics.jsonl",
    "chest_phantom_full": "docs/quality_chest_r3/metrics_bound065.jsonl",
    "chest_phantom_best": "docs/quality_chest_r3/metrics_bound010.jsonl",
    "chest_phantom_finetune": "docs/quality_chest_r3/metrics_consolidate.jsonl",
    **{exp: f"docs/quality_attribution_r4/metrics_{exp}.jsonl"
       for exp in ("chest_phantom_views100", "chest_phantom_views200",
                   "chest_phantom_views200_b01", "chest_phantom_tvd",
                   "chest_phantom_smooth")},
}

Summary = Optional[Tuple[float, float, float]]


def summarize(path: str) -> Summary:
    """(peak psnr_3d, final psnr_3d, final ssim_3d) of a ``metrics.jsonl``,
    or None when the file or its evals are missing (the JAX script's
    reading)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        ls = [json.loads(line) for line in f]
    ev = [(r["step"], r["value"]) for r in ls if r["tag"] == "eval/psnr_3d"]
    ssim = [(r["step"], r["value"]) for r in ls if r["tag"] == "eval/ssim_3d"]
    if not ev:
        return None
    return max(v for _, v in ev), ev[-1][1], (ssim[-1][1] if ssim else float("nan"))


def config_of(name: str) -> Dict:
    from neuralvolumetricreconstructionformedicalimages_torch.config import load_config
    return load_config(os.path.join("configs", f"{name}.yaml"))


def port_metrics(name: str, logs: str = LOGS) -> str:
    """The port's log of config ``name`` as its run left it."""
    return os.path.join(logs, config_of(name)["exp"]["expname"], f"metrics_{name}.jsonl")


def last_eval_dir(name: str, logs: str = LOGS) -> str:
    """The eval directory of the run's last epoch (the trainer evaluates at
    its last epoch)."""
    cfg = config_of(name)
    return os.path.join(logs, cfg["exp"]["expname"], "eval",
                        f"epoch_{int(cfg['train']['epoch']):05d}")


def collect(runs: Sequence[Tuple[str, str]], out: str, logs: str = LOGS) -> List[tuple]:
    """Each run's row (config, description, port summary, JAX summary);
    its log and last eval's ``.txt``/``.png`` copied into ``out``."""
    os.makedirs(out, exist_ok=True)
    rows = []
    for name, desc in runs:
        path = port_metrics(name, logs)
        mine = summarize(path)
        if mine is not None:
            shutil.copy(path, os.path.join(out, f"metrics_{name}.jsonl"))
            copy_eval_files(last_eval_dir(name, logs), out, f"{name}_")
        jax_path = JAX_METRICS.get(name)
        rows.append((name, desc, mine, summarize(jax_path) if jax_path else None))
    return rows


def table(rows: Sequence[tuple]) -> str:
    """The Markdown table: the port's peak, final and final SSIM beside
    the JAX run's (``(missing)`` where a log is absent)."""
    def cells(s: Summary) -> str:
        return "(missing) | | " if s is None else f"{s[0]:.2f} | {s[1]:.2f} | {s[2]:.3f}"

    lines = ["| run | port peak 3D PSNR | port final | port final SSIM | "
             "JAX peak 3D PSNR | JAX final | JAX final SSIM |",
             "|---|---|---|---|---|---|---|"]
    for name, desc, mine, theirs in rows:
        lines.append(f"| {desc} (`{name}`) | {cells(mine)} | "
                     + ("(no JAX log) | | " if name not in JAX_METRICS else cells(theirs))
                     + " |")
    return "\n".join(lines) + "\n"


def readme(title: str, rows: Sequence[tuple], card: str) -> str:
    return "\n".join([
        f"# {title}", "",
        f"Port runs on {card}, trained by `scripts/train_full_torch.py` through "
        "`train/cli.py`, read by `scripts/quality_summary_torch.py`; the JAX figures "
        "read from the JAX runs' committed logs (`" + "`, `".join(
            sorted({JAX_METRICS[n] for n, *_ in rows if n in JAX_METRICS})) + "`). "
        "The JAX runs predate the ray-precision fix: no quality gate.", "",
        table(rows)])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train", action="store_true",
                   help="train the study's configs first")
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        resolve_device)
    from real_scale_train_r5_torch import card_line

    resolve_device("cuda")
    if args.train:
        import train_full_torch
        rc = train_full_torch.main(
            [a for name in STUDY for a in ("--config", f"configs/{name}.yaml")]
            + ["--out", os.path.join(LOGS, "quality_study.json")])
        if rc:
            return rc
    card = card_line("cuda")
    for title, runs, out in (
            ("Chest-phantom attribution runs, PyTorch port", RUNS, OUT_ATTRIBUTION),
            ("Chest-phantom quality runs, PyTorch port", CHEST_RUNS, OUT_CHEST)):
        rows = collect(runs, out)
        text = readme(title, rows, card)
        with open(os.path.join(out, "README.md"), "w") as f:
            f.write(text)
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
