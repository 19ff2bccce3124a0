#!/usr/bin/env python3
"""Train configs to the end on the card through the port's CLI
(``train/cli.py``) and summarize each run: every eval's proj_psnr,
psnr_3d and ssim_3d, the loss curve (each epoch's mean loss) and the wall
time.

    python3 scripts/train_full_torch.py [--config configs/smoke.yaml ...] \
        [--out chiprun_out/full_runs.json]

A config whose dataset is missing and that the generator can make
(``SCANS``: ``data/lamino_chip.pickle`` from ``configs/scans/lamino_chip.yaml``)
gets it from ``data/generate.py``'s CLI on the card first.  Each run
starts fresh in ``logs/full/<expname>``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("configs/smoke.yaml", "configs/chest_phantom_r3.yaml",
           "configs/lamino_chip.yaml")
# dataset -> (scan config, phantom) for the generator
SCANS = {"./data/lamino_chip.pickle": ("configs/scans/lamino_chip.yaml", "lamino_chip")}


def summarize(metrics_path: str) -> dict:
    """Evals (by global step) and the loss curve from ``metrics.jsonl``."""
    evals, loss = {}, []
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"].startswith("eval/"):
                evals.setdefault(rec["step"], {})[rec["tag"][5:]] = rec["value"]
            elif rec["tag"] == "train/loss":
                loss.append((rec["step"], rec["value"]))
    return {"evals": [{"step": s, **m} for s, m in sorted(evals.items())],
            "loss_curve": loss}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", action="append", default=None,
                   help="config to train (repeatable; default: the three of CONFIGS)")
    p.add_argument("--out", default=os.path.join("chiprun_out", "full_runs.json"))
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)

    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.config import load_config
    from neuralvolumetricreconstructionformedicalimages_torch.train import cli

    if not torch.cuda.is_available():
        print("train_full_torch: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    results = {"card": smi, "device": torch.cuda.get_device_name(0), "runs": {}}
    for cfg_path in args.config or CONFIGS:
        cfg = load_config(cfg_path)
        run = {"config": cfg_path, "epochs": int(cfg["train"]["epoch"])}
        datadir = cfg["exp"]["datadir"]
        if not os.path.exists(datadir) and datadir in SCANS:
            scan, phantom = SCANS[datadir]
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m",
                            "neuralvolumetricreconstructionformedicalimages_torch.data.generate",
                            "--phantom", phantom, "--config", scan, "--outputFolder",
                            os.path.dirname(datadir), "--outputName",
                            os.path.splitext(os.path.basename(datadir))[0]], check=True)
            run["generate_s"] = time.perf_counter() - t0
        workdir = os.path.join("logs", "full", cfg["exp"]["expname"])
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["--config", cfg_path, "--workdir", workdir])
        torch.cuda.synchronize()
        run["wall_s"] = time.perf_counter() - t0
        run.update(summarize(os.path.join(workdir, "metrics.jsonl")))
        results["runs"][cfg_path] = run
        curve = run["loss_curve"]
        picks = sorted({0, len(curve) // 4, len(curve) // 2, 3 * len(curve) // 4,
                        len(curve) - 1})
        print(f"[full] {cfg_path}: {run['epochs'] + 1} epochs in {run['wall_s']:.1f} s; "
              "loss " + ", ".join(f"step {curve[i][0]}: {curve[i][1]:.6g}" for i in picks))
        for ev in run["evals"]:
            print(f"[full]   eval at step {ev['step']}: proj_psnr {ev['proj_psnr']:.3f} dB, "
                  f"psnr_3d {ev.get('psnr_3d', float('nan')):.3f} dB, "
                  f"ssim_3d {ev.get('ssim_3d', float('nan')):.4f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"[full] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
