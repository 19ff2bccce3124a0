#!/usr/bin/env python3
"""Real-laminography-scale training smoke: 187 views x 1024^2 on one card.

The port of ``scripts/real_scale_smoke.py``.  The reference's real scan
(``data/format_real.py`` + ``data/angles_real.npy``) needs rays for
187 x 1024^2 pixels, 5.8 GiB if precomputed.  This builds a dataset at
exactly that scale (random projection content, ``default_rng(0)``; the
real projections are not redistributable), which switches to the
on-the-fly ray mode by itself, and runs chest_50-scale training steps
through the port's ``make_epoch_fn`` (``build_model`` + ``make_optimizer``;
4-step epochs of 1024 rays x 192 samples, unmasked): a warm-up epoch (the
eager step, the capture of the step as a CUDA graph, replays), then 3
timed epochs.  It prints the step time, rays/s and the peak device memory
(``torch.cuda.max_memory_allocated``): the memory plan is what it proves.

    python3 scripts/real_scale_smoke_torch.py [--out docs/real_scale_torch/smoke.md]
        [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VIEWS, H, W = 187, 1024, 1024
N_RAYS, N_SAMPLES, STEPS = 1024, 192, 4
OUT = "docs/real_scale_torch/smoke.md"


def scan_dict(n_views: int = N_VIEWS, h: int = H, w: int = W) -> Dict[str, Any]:
    """The real scan's geometry dict (``data/format_real.py``'s shape: a
    parallel beam tilted 29 degrees, a ``w`` x ``h`` detector) with
    ``n_views`` random views of content in [0, 0.1) at the measured
    angles."""
    angles = np.load("data/angles_real.npy").astype(np.float32)[:n_views]
    return {
        "DSD": 1500.0, "DSO": 1000.0,
        "nDetector": [w, h], "dDetector": [0.5, 0.5],
        "nVoxel": [256, 256, 64], "dVoxel": [1.0, 1.0, 1.0],
        "offOrigin": [0, 0, 0], "offDetector": [0, 0],
        "accuracy": 0.5, "mode": "parallel", "filter": None,
        "totalAngle": 180, "startAngle": 0, "randomAngle": False,
        "numTrain": n_views, "numVal": 1, "convert": False,
        "rescale_slope": 1.0, "rescale_intercept": 0.0,
        "normalize": True, "noise": 0, "tilt_angle": 29.0,
        "train": {
            "angles": angles,
            "projections": np.random.default_rng(0)
            .random((n_views, h, w), np.float32) * 0.1,
        },
    }


def smoke_cfg() -> Dict[str, Any]:
    """``configs/chest_50.yaml`` at ``N_SAMPLES`` samples a ray."""
    from neuralvolumetricreconstructionformedicalimages_torch.config import (
        load_config, with_defaults)
    cfg = with_defaults(load_config("configs/chest_50.yaml"))
    cfg["render"]["n_samples"] = N_SAMPLES
    return cfg


def run(timed_epochs: int = 3, device=None) -> Dict[str, Any]:
    """Build the dataset and the model, run the warm-up epoch and
    ``timed_epochs`` timed ones (CUDA events on the card, the host clock on
    the CPU); the figures, with every epoch's losses."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        make_dataset)
    from neuralvolumetricreconstructionformedicalimages_torch.train.optim import (
        make_optimizer)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        build_model, make_epoch_fn, pin_fp32, resolve_device)
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        StepTimer)

    dev = resolve_device(device)
    pin_fp32()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dset = make_dataset(scan_dict(), "train", n_rays=N_RAYS, device=dev)
    dataset_s = time.perf_counter() - t0
    avoided_gib = N_VIEWS * H * W * 8 * 4 / 2 ** 30
    print(f"dataset built in {dataset_s:.1f}s  ray_mode={dset.ray_mode} (ray tensor "
          f"would be {avoided_gib:.1f} GiB)", flush=True)
    assert dset.ray_mode == "onthefly"

    cfg = smoke_cfg()
    g = torch.Generator(device=dev).manual_seed(1)
    field = build_model(cfg, g, dev)
    epoch_fn = make_epoch_fn(cfg, field, make_optimizer(cfg, field.parameters()),
                             STEPS, n_rays=N_RAYS, n_batch=1, use_mask=False,
                             generator=g, geo=dset.geo, near=dset.near, far=dset.far)
    arrays = dset.arrays()
    order = torch.as_tensor(np.arange(STEPS).reshape(-1, 1) % N_VIEWS, device=dev)

    print("warm-up (the eager step, the capture, replays)...", flush=True)
    t0 = time.perf_counter()
    losses = [epoch_fn(arrays, order, 0).cpu()]
    warm_s = time.perf_counter() - t0
    print(f"warmup {warm_s:.1f}s loss={float(losses[0].mean()):.4f}", flush=True)
    epoch_ms = []
    for i in range(timed_epochs):
        timer = StepTimer(dev)
        timer.tick()
        out = epoch_fn(arrays, order, (i + 1) * STEPS)
        timer.tick()
        epoch_ms.append(timer.step_ms()[0])
        losses.append(out.cpu())
    best = min(epoch_ms) / 1e3
    rec = {
        "views": N_VIEWS, "detector": [H, W], "ray_mode": dset.ray_mode,
        "ray_tensor_avoided_gib": avoided_gib, "n_rays": N_RAYS,
        "n_samples": N_SAMPLES, "steps_per_epoch": STEPS, "dataset_s": dataset_s,
        "warm_s": warm_s, "epoch_ms": epoch_ms, "ms_per_step": best / STEPS * 1e3,
        "rays_s": STEPS * N_RAYS / best,
        "peak_allocated_mb": torch.cuda.max_memory_allocated() / 1e6 if cuda else None,
        "losses": torch.cat(losses).tolist(), "device": str(dev),
    }
    print(f"steady: {rec['ms_per_step']:.3f} ms/step ({rec['rays_s']:,.0f} rays/s) at "
          f"{N_VIEWS}x{H}x{W} scale, on-the-fly rays; peak allocated "
          f"{rec['peak_allocated_mb']} MB", flush=True)
    return rec


def report(rec: Dict[str, Any], card: str) -> str:
    """The Markdown page of :func:`run`'s figures."""
    lines = [
        "# Real-laminography-scale smoke, PyTorch + CUDA port",
        "",
        "`python3 scripts/real_scale_smoke_torch.py`: "
        f"{rec['views']} random views of {rec['detector'][0]}x{rec['detector'][1]} "
        "at the measured angles (tilted parallel beam), the chest_50 model at "
        f"full width, {rec['steps_per_epoch']}-step epochs of {rec['n_rays']} rays x "
        f"{rec['n_samples']} samples through `make_epoch_fn` (one eager step, a "
        "captured CUDA graph, replays), unmasked.",
        "",
        "| figure | value |",
        "|---|---|",
        f"| ray mode | {rec['ray_mode']} (a {rec['ray_tensor_avoided_gib']:.1f} GiB ray "
        "tensor avoided) |",
        f"| dataset build (host) | {rec['dataset_s']:.1f} s |",
        f"| warm-up epoch (eager step, capture, replays) | {rec['warm_s']:.2f} s |",
        "| timed epochs | " + ", ".join(f"{x:.3f}" for x in rec["epoch_ms"]) + " ms |",
        f"| step (best epoch) | {rec['ms_per_step']:.3f} ms |",
        f"| rays/s | {rec['rays_s']:,.0f} |",
        "| peak allocated | " + ("not measured" if rec["peak_allocated_mb"] is None
                                 else f"{rec['peak_allocated_mb']:.1f} MB") + " |",
        "",
        f"Device: {rec['device']} ({card}); generated {time.strftime('%Y-%m-%d %H:%M')}.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import real_scale_train_r5_torch as r5

    rec = run(device=args.device)
    out = report(rec, r5.card_line(rec["device"]))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out)
    print(f"\nwrote {args.out}:\n\n{out}")
    print("REAL-SCALE SMOKE PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
