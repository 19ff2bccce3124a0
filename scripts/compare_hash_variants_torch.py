#!/usr/bin/env python3
"""Reconstruction quality of the coherent (linear) hash against the XOR hash.

The coherent hash replaces the reference's XOR-prime collision hash with a
linear one whose lattice-structured collisions allow the span gather's
wide-row reads (``ops/coherent_hash.py``).  The collision rate is the same;
the structure differs.  This trains ``hash_variant: coherent`` (f32 and
bf16 gather tables) and ``hash_variant: xor`` from the same seed, model
and optimizer at a scale where most levels are hashed, and compares the 3D
PSNR and SSIM (``metrics.py``) of each recovered volume against the ground
truth.

Protocol: a 64^3 Shepp-Logan scan (seed 3) with 25 views of 64^2, an
8-level 2^13 hash grid, 256 rays x 96 samples a step, one view a step;
each variant through the port's ``build_model``, ``make_optimizer`` and
``make_epoch_fn`` (one eager step, then a captured CUDA graph replayed).

    python3 scripts/compare_hash_variants_torch.py [--epochs N] \
        [--out docs/hash_quality_torch.md] [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Any, Dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = "docs/hash_quality_torch.md"

SCAN = {
    "nDetector": [64, 64],
    "dDetector": [4.0, 4.0],
    "nVoxel": [64, 64, 64],
    "dVoxel": [2.0, 2.0, 2.0],
    "numTrain": 25,
    "numVal": 5,
}

BASE_CFG = {
    "exp": {"expname": "hash_compare", "expdir": "logs", "datadir": ""},
    "network": {"net_type": "mlp", "num_layers": 4, "hidden_dim": 32,
                "skips": [2], "out_dim": 1, "last_activation": "sigmoid",
                "bound": 0.3},
    "encoder": {"encoding": "hashgrid", "input_dim": 3, "num_levels": 8,
                "level_dim": 2, "base_resolution": 8,
                # a 2^13 table with levels up to a resolution of ~1024:
                # levels 2 and up are hashed, so collisions dominate
                "log2_hashmap_size": 13},
    "render": {"n_samples": 96, "n_fine": 0, "perturb": True,
               "raw_noise_std": 0.0},
    "train": {"epoch": 0, "n_batch": 1, "n_rays": 256, "lrate": 0.001,
              "lrate_gamma": 0.1, "lrate_step": 10_000, "seed": 7},
    "log": {"i_eval": 0, "i_save": 0},
}

VARIANTS = {
    "coherent": {"hash_variant": "coherent", "table_dtype": "float32"},
    "coherent-bf16": {"hash_variant": "coherent", "table_dtype": "bfloat16"},
    "xor": {"hash_variant": "xor"},
}


def train_variant(cfg: Dict[str, Any], dset, epochs: int, label: str, dev):
    """Train ``cfg``'s field ``epochs`` epochs on ``dset`` (every view once
    an epoch, in order); the recovered volume on the voxel grid and the
    last epoch's mean loss."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.render import query_field
    from neuralvolumetricreconstructionformedicalimages_torch.train.optim import (
        make_optimizer)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        build_model, make_epoch_fn)

    init = torch.Generator(device=dev).manual_seed(int(cfg["train"]["seed"]))
    field = build_model(cfg, init, dev)
    steps = dset.n_views                      # one view a step
    draws = torch.Generator(device=dev).manual_seed(100)
    epoch_fn = make_epoch_fn(cfg, field, make_optimizer(cfg, field.parameters()), steps,
                             n_rays=int(cfg["train"]["n_rays"]), n_batch=1,
                             use_mask=False, generator=draws)
    arrays = dset.arrays()
    order = torch.arange(steps, device=dev).reshape(steps, 1)
    t0 = time.time()
    loss = float("nan")
    for ep in range(epochs):
        losses = epoch_fn(arrays, order, ep * steps)
        if ep % 25 == 0 or ep == epochs - 1:
            loss = float(losses.mean())
            print(f"  [{label}] epoch {ep:4d}/{epochs} loss={loss:.3e} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    vol = query_field(dset.voxels, field)[..., 0].cpu().numpy()
    return vol, loss, time.time() - t0


def run(epochs: int, device=None, scan: Dict[str, Any] = SCAN) -> Dict[str, Any]:
    """Every variant of :data:`VARIANTS` trained ``epochs`` epochs on the
    scan of ``scan``; the figures of each and the grid's hashed levels."""
    from neuralvolumetricreconstructionformedicalimages_torch.config import with_defaults
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import make_dataset
    from neuralvolumetricreconstructionformedicalimages_torch.data.generate import generate
    from neuralvolumetricreconstructionformedicalimages_torch.metrics import (
        get_psnr_3d, get_ssim_3d)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        build_model, pin_fp32, resolve_device)

    dev = resolve_device(device)
    pin_fp32()
    print(f"generating the phantom scan ({scan['nVoxel']} shepp-logan, "
          f"{scan['numTrain']} views of {scan['nDetector']})...", flush=True)
    data = generate(scan, phantom="shepp_logan", seed=3, device=dev)
    dset = make_dataset(data, "train", n_rays=int(BASE_CFG["train"]["n_rays"]), device=dev)
    gt = dset.image.cpu().numpy()
    grid = build_model(with_defaults(BASE_CFG)).encoder.grid
    n_hashed = int((~grid.dense_levels).sum())
    print(f"{n_hashed}/{grid.num_levels} levels hashed (resolutions "
          f"{[int(r) for r in grid.resolutions]})", flush=True)
    results = {}
    for name, enc_over in VARIANTS.items():
        cfg = with_defaults({**BASE_CFG, "encoder": {**BASE_CFG["encoder"], **enc_over}})
        print(f"training variant {name!r} for {epochs} epochs...", flush=True)
        vol, loss, wall = train_variant(cfg, dset, epochs, name, dev)
        results[name] = {"psnr_3d": get_psnr_3d(vol, gt), "ssim_3d": get_ssim_3d(vol, gt),
                         "final_loss": loss, "wall_s": wall}
        print(f"  [{name}] PSNR_3D={results[name]['psnr_3d']:.2f} dB  "
              f"SSIM={results[name]['ssim_3d']:.4f}", flush=True)
    return {"results": results, "n_hashed": n_hashed, "num_levels": grid.num_levels,
            "device": str(dev), "scan": scan}


def report(res: Dict[str, Any], epochs: int, card: str) -> str:
    """The Markdown page of :func:`run`'s figures."""
    results = res["results"]
    delta = results["coherent"]["psnr_3d"] - results["xor"]["psnr_3d"]
    lines = [
        "# Hash-variant quality comparison, PyTorch + CUDA port "
        "(coherent/linear vs reference XOR)",
        "",
        f"Protocol: `scripts/compare_hash_variants_torch.py --epochs {epochs}`: "
        f"a {res['scan']['nVoxel'][0]}-cube Shepp-Logan phantom, "
        f"{res['scan']['numTrain']} views of {res['scan']['nDetector'][0]}x"
        f"{res['scan']['nDetector'][1]}, an 8-level 2^13 hash grid "
        f"({res['n_hashed']}/{res['num_levels']} levels hashed: collisions "
        "dominate), the same seed, model and optimizer for every variant, trained "
        "through the port's `make_epoch_fn`; 3D PSNR/SSIM of the recovered volume "
        "against the ground truth.",
        "",
        "| variant | PSNR_3D (dB) | SSIM_3D | final loss | train wall (s) |",
        "|---|---|---|---|---|",
    ]
    for name, r in results.items():
        lines.append(f"| {name} | {r['psnr_3d']:.2f} | {r['ssim_3d']:.4f} "
                     f"| {r['final_loss']:.3e} | {r['wall_s']:.1f} |")
    lines += [
        "",
        f"**coherent - xor = {delta:+.2f} dB.** "
        + ("The linear hash's lattice collisions cost no reconstruction quality at "
           "this collision rate." if abs(delta) <= 0.5 else
           "NOTE: the gap exceeds 0.5 dB; revisit the mixing multipliers "
           "(ops/coherent_hash.py)."),
        "",
        f"Device: {res['device']} ({card}); generated "
        f"{time.strftime('%Y-%m-%d %H:%M')}.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    res = run(args.epochs, args.device)
    card = "CPU"
    if res["device"].startswith("cuda"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = report(res, args.epochs, card)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out)
    print(f"\nwrote {args.out}:\n\n{out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
