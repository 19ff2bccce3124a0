#!/usr/bin/env python3
"""Rays/s against the batch: the training step at 1,024 to 8,192 rays.

The port of ``scripts/batch_sweep.py``.  It times the chest_50 model's full
optimizer step (render forward, encoder backward, Adam; 192 samples a ray,
the 16 x 2^19 x 2 table) at each ``--batches`` ray count, for each
``--dtypes`` gather-table dtype (``encoder.table_dtype``), on a 50-view
256^2 cone scan with random targets, in two harnesses:

- ``epoch``: ``make_epoch_fn`` on a view order, one view a step (each step
  draws its pixels and its stratified jitter);
- ``iso``: one fixed ray batch (the first ``n_rays`` rays of view 0) and a
  fixed random target, ``perturb`` off, through the same field, loss and
  capturable Adam (:func:`iso_loss`, :func:`make_iso_step`).

Each harness's step is captured as one CUDA graph and replayed
(``train/trainer.py::_GraphedStep``), so neither has the host in its loop.
Each harness runs a warm-up block (the eager step and the capture) and 3
timed blocks of ``--steps`` steps (CUDA events around a block); its step
time is the best block's over ``--steps``.  One more block of each runs
under ``torch.profiler`` for the device ms a step.  Every configuration
runs in a fresh process (the caching allocator's state would carry over),
which prints one ``SWEEPREC`` JSON line: ``iso_ms``, ``iso_rays_s``,
``epoch_ms``, ``epoch_rays_s``, ``warm_s``, the device ms a step of each
harness, the peak allocated memory and the kernels' launches in each
harness's timed blocks (``launches``, ``iso_launches``).  The parent
writes the table to ``docs/batch_scaling_torch.md``.

    python3 scripts/batch_sweep_torch.py [--batches 1024,2048,4096,8192]
        [--dtypes float32,bfloat16] [--steps 8] [--out FILE] [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES = 192
N_VIEWS, H, W = 50, 256, 256
OUT = "docs/batch_scaling_torch.md"
TIMED = 3                     # timed blocks of each harness


def sweep_cfg(n_rays: int, table_dtype: str) -> Dict[str, Any]:
    """``configs/chest_50.yaml`` at ``N_SAMPLES`` samples, ``n_rays`` rays
    a step and the gather table in ``table_dtype``."""
    from neuralvolumetricreconstructionformedicalimages_torch.config import (
        load_config, with_defaults)
    cfg = with_defaults(load_config("configs/chest_50.yaml"))
    cfg["render"]["n_samples"] = N_SAMPLES
    cfg["train"]["n_rays"] = n_rays
    cfg["encoder"]["table_dtype"] = table_dtype
    return cfg


def scan_arrays(device, n_views: int = N_VIEWS, det=(H, W), n_voxel: int = 128,
                d_voxel: float = 0.002, d_det: float = 0.002) -> Dict[str, Any]:
    """The step's arrays of an ``n_views`` cone scan of ``det`` pixels
    (``d_det`` m) over ``n_voxel``^3 voxels of ``d_voxel`` m, the views over
    half a turn (default: 50 views of 256^2, 2 mm voxels over 128^3):
    precomputed rays, random targets in [0, 0.1), every pixel valid and
    unmasked."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch import geometry as G
    h, w = det
    geo = G.ConeGeometry(
        DSD=1.5, DSO=1.0, nDetector=(w, h), dDetector=(d_det, d_det),
        nVoxel=(n_voxel,) * 3, dVoxel=(d_voxel,) * 3, mode="cone")
    near, far = G.get_near_far(geo)
    angles = np.linspace(0, np.pi, n_views, endpoint=False).astype(np.float32)
    ro, rd = G.rays_for_angles(geo, angles, device)
    g = torch.Generator(device=device).manual_seed(0)
    return {
        "rays": G.pack_rays(ro, rd, near, far),
        "projs": torch.rand((n_views, h, w), generator=g, device=device) * 0.1,
        "mask": torch.ones((n_views, h, w), device=device),
        "pools": torch.arange(h * w, dtype=torch.int32, device=device)
        .expand(n_views, h * w).contiguous(),
        "pool_counts": torch.full((n_views,), h * w, dtype=torch.int32, device=device),
    }


def iso_loss(field, rays, target, n_samples: int = N_SAMPLES):
    """The isolated step's loss: ``rays`` rendered without jitter, their
    MSE against ``target``."""
    from neuralvolumetricreconstructionformedicalimages_torch.losses import masked_mse
    from neuralvolumetricreconstructionformedicalimages_torch.render import render_rays

    out = render_rays(rays, field, n_samples=n_samples, perturb=False)
    return masked_mse(out["acc"], target, None)


def make_iso_step(field, optimizer, rays, target, n_samples: int = N_SAMPLES):
    """One optimizer step on the fixed batch, as ``_GraphedStep`` calls a
    step (``step(arrays, views)``; both unused)."""
    def step(arrays, views):
        optimizer.zero_grad(set_to_none=True)
        loss = iso_loss(field, rays, target, n_samples)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _block_ms(run, dev) -> float:
    """Milliseconds of one call of ``run`` (CUDA events on the card)."""
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        StepTimer)
    timer = StepTimer(dev)
    timer.tick()
    run()
    timer.tick()
    return timer.step_ms()[0]


def child(n_rays: int, dtype: str, steps: int, device=None) -> Dict[str, Any]:
    """Measure one configuration in this (fresh) process; print and return
    its ``SWEEPREC``."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
    from neuralvolumetricreconstructionformedicalimages_torch.train.optim import (
        make_optimizer)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        _GraphedStep, build_model, make_epoch_fn, pin_fp32, resolve_device)
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        traced_device_ms)

    dev = resolve_device(device)
    pin_fp32()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg = sweep_cfg(n_rays, dtype)
    arrays = scan_arrays(dev)

    # epoch harness
    g = torch.Generator(device=dev).manual_seed(1)
    field = build_model(cfg, g, dev)
    epoch_fn = make_epoch_fn(cfg, field, make_optimizer(cfg, field.parameters()), steps,
                             n_rays=n_rays, n_batch=1, use_mask=False, generator=g)
    order = torch.as_tensor(np.arange(steps).reshape(-1, 1) % N_VIEWS, device=dev)
    t0 = time.perf_counter()
    first = epoch_fn(arrays, order, 0).cpu()
    warm = time.perf_counter() - t0
    _build.reset_launches()
    ep = [_block_ms(lambda i=i: epoch_fn(arrays, order, (i + 1) * steps), dev)
          for i in range(TIMED)]
    launches = dict(_build.LAUNCHES)
    last_epoch = lambda: epoch_fn(arrays, order, (TIMED + 1) * steps).cpu()  # noqa: E731
    if cuda:
        last, epoch_dev, _, _ = traced_device_ms(last_epoch)
        epoch_dev /= steps
    else:
        last, epoch_dev = last_epoch(), None
    peak_epoch = torch.cuda.max_memory_allocated() / 1e6 if cuda else None
    del epoch_fn

    # isolated step: the first n_rays rays of view 0, a fixed target
    gi = torch.Generator(device=dev).manual_seed(1)
    ifield = build_model(cfg, gi, dev)
    opt = make_optimizer(cfg, ifield.parameters())
    rays = arrays["rays"].reshape(-1, 8)[:n_rays]
    target = torch.rand((n_rays,), generator=torch.Generator(device=dev).manual_seed(2),
                        device=dev) * 0.1
    step = make_iso_step(ifield, opt, rays, target)
    graphed = _GraphedStep(step, opt, None)
    views = torch.zeros((1,), dtype=torch.long, device=dev)

    def iso_block():
        for _ in range(steps):
            out = graphed({}, {"views": views}) if cuda else step({}, views)
        return out

    iso_warm = _block_ms(iso_block, dev)
    _build.reset_launches()
    iso = [_block_ms(iso_block, dev) for _ in range(TIMED)]
    iso_launches = dict(_build.LAUNCHES)
    iso_dev = traced_device_ms(iso_block)[1] / steps if cuda else None
    iso_loss_last = float(iso_block())

    t_epoch, t_iso = min(ep) / steps / 1e3, min(iso) / steps / 1e3
    rec = {
        "n_rays": n_rays, "table_dtype": dtype, "steps": steps,
        "iso_ms": t_iso * 1e3, "iso_rays_s": n_rays / t_iso,
        "epoch_ms": t_epoch * 1e3, "epoch_rays_s": n_rays / t_epoch,
        "warm_s": warm, "iso_warm_ms": iso_warm,
        "epoch_device_ms": epoch_dev, "iso_device_ms": iso_dev,
        "epoch_block_ms": ep, "iso_block_ms": iso,
        "peak_epoch_mb": peak_epoch,
        "peak_mb": torch.cuda.max_memory_allocated() / 1e6 if cuda else None,
        "points_a_level": n_rays * N_SAMPLES, "timed_epoch_steps": TIMED * steps,
        "launches": launches, "iso_launches": iso_launches,
        "loss_first": float(first[0]),
        "loss_last": float(last[-1]), "iso_loss_last": iso_loss_last,
    }
    print("SWEEPREC " + json.dumps(rec), flush=True)
    return rec


def report(recs: List[Dict[str, Any]], card: str, steps: int) -> str:
    """The Markdown page of the sweep's records."""
    lines = [
        "# Rays/s against the batch, PyTorch + CUDA port",
        "",
        f"`python3 scripts/batch_sweep_torch.py --steps {steps}`: the chest_50 model's "
        f"full optimizer step (render forward, encoder backward, Adam; {N_SAMPLES} "
        "samples a ray, 16 x 2^19 x 2 table) on a 50-view 256^2 cone scan with "
        "random targets; each configuration in a fresh process.  `epoch`: "
        "`make_epoch_fn`, one view a step, per-step pixel and jitter draws; `iso`: "
        "one fixed batch, `perturb` off.  Both replay one captured CUDA graph a "
        f"step; step ms is the best of {TIMED} blocks of {steps} steps (CUDA "
        "events), device ms a step from one profiled block.",
        "",
        "| table dtype | rays/step | points a level | epoch ms | epoch rays/s | "
        "epoch device ms | iso ms | iso rays/s | iso device ms | peak MB | warm-up s |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]

    def f(x, fmt):
        return "n/a" if x is None else format(x, fmt)

    for r in recs:
        lines.append(
            f"| {r['table_dtype']} | {r['n_rays']} | {r['points_a_level']:,} | "
            f"{r['epoch_ms']:.3f} | {r['epoch_rays_s']:,.0f} | "
            f"{f(r['epoch_device_ms'], '.3f')} | {r['iso_ms']:.3f} | "
            f"{r['iso_rays_s']:,.0f} | {f(r['iso_device_ms'], '.3f')} | "
            f"{f(r['peak_mb'], '.1f')} | {r['warm_s']:.2f} |")
    lines += ["", f"Card: {card}; generated {time.strftime('%Y-%m-%d %H:%M')}."]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batches", default="1024,2048,4096,8192")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    ap.add_argument("--child", default=None, help="internal: 'n_rays,dtype'")
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    if args.child:
        n, d = args.child.split(",")
        child(int(n), d, args.steps, args.device)
        return 0

    import real_scale_train_r5_torch as r5
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        resolve_device)
    dev = resolve_device(args.device)
    # one fresh process a configuration: the caching allocator's state and
    # its fragmentation would carry from one to the next
    recs = []
    for dtype in args.dtypes.split(","):
        for n_rays in [int(b) for b in args.batches.split(",")]:
            print(f"[sweep] {time.strftime('%H:%M:%S')} n_rays={n_rays} "
                  f"table={dtype}", flush=True)
            cmd = [sys.executable, os.path.abspath(__file__), "--child",
                   f"{n_rays},{dtype}", "--steps", str(args.steps)]
            if args.device:
                cmd += ["--device", args.device]
            out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            sys.stdout.write(out.stdout)
            if out.returncode != 0:
                sys.stderr.write(out.stderr)
                raise RuntimeError(f"the sweep's child {n_rays},{dtype} failed "
                                   f"(exit {out.returncode})")
            recs += [json.loads(line.split(" ", 1)[1]) for line in out.stdout.splitlines()
                     if line.startswith("SWEEPREC ")]
    text = report(recs, r5.card_line(dev), args.steps)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"\nwrote {args.out}:\n\n{text}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
