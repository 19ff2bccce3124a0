#!/usr/bin/env python3
"""Scaling sweep: sharded-epoch throughput against the number of ranks.

The port of ``scripts/scaling_sweep.py``: the production sharded epoch
(``parallel/step.py::make_sharded_epoch_fn``) over meshes of {1, 2, 4, 8}
ranks, one process a rank meeting through
``parallel/mesh.py::initialize_multihost`` under gloo, with rays/s and the
efficiency against the one-rank run.  Strong scaling: the global batch
(``--n-rays``) is fixed; each rank renders ``n_rays / ranks`` rays.

With one card, the ranks either run on the CPU (``--device cpu``) or share
``cuda:0`` (NCCL refuses two ranks on one card).  Neither measures
scaling: CPU ranks share the host's cores, and ranks sharing the card
contend for it; both exercise the code a multi-card mesh runs (the
sharding, the exact global loss, the generator folds, the all-reduce).

    python3 scripts/scaling_sweep_torch.py [--device cpu] [--n-rays 1024]
        [--n-samples 64] [--log2-table 15] [--steps 8] [--backward take]
        [--out PATH]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.  Writes ``docs/scaling_sweep_torch_card.md`` (or ``_cpu.md``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Sequence

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1, 2, 4, 8)
TIMED_EPOCHS = 3
N_VIEWS, DET = 8, 64
OUT = {"cpu": "docs/scaling_sweep_torch_cpu.md", "cuda": "docs/scaling_sweep_torch_card.md"}


def sweep_cfg(n_rays: int, n_samples: int, log2_table: int, backward: str) -> Dict[str, Any]:
    """``configs/chest_50.yaml`` with the sweep's overrides."""
    from neuralvolumetricreconstructionformedicalimages_torch.config import (
        load_config, with_defaults)
    cfg = with_defaults(load_config(os.path.join(ROOT, "configs", "chest_50.yaml")))
    cfg["render"]["n_samples"] = n_samples
    cfg["train"]["n_rays"] = n_rays
    cfg["encoder"]["log2_hashmap_size"] = log2_table
    cfg["encoder"]["backward"] = backward
    return cfg


def sweep_arrays(device) -> Dict[str, Any]:
    """The JAX script's scan: 8 cone-beam views of 64^2 of a 64^3 volume
    (4 mm voxels), rays precomputed, projections a seeded uniform draw x
    0.1, no mask."""
    from batch_sweep_torch import scan_arrays
    return scan_arrays(device, N_VIEWS, (DET, DET), n_voxel=64, d_voxel=0.004)


def efficiency(rate: float, base_rate: float, n: int) -> float:
    """Strong-scaling efficiency against the one-rank rate (the JAX
    script's formula)."""
    return rate / (base_rate * n)


def sweep_rank(rank: int, world: int, port: int, device: str, cfg: Dict[str, Any],
               steps: int) -> Dict[str, Any]:
    """One rank of a ``data=world`` mesh: a warm-up epoch, then
    ``TIMED_EPOCHS`` epochs between barriers; this rank's epoch times."""
    import torch
    import torch.distributed as dist
    from multiprocess_smoke_torch import join_group

    join_group(rank, world, port, device)
    try:
        from neuralvolumetricreconstructionformedicalimages_torch.parallel import (
            MeshSpec, make_mesh, make_sharded_epoch_fn)
        from neuralvolumetricreconstructionformedicalimages_torch.train.optim import (
            make_optimizer)
        from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
            build_model, pin_fp32)
        dev = torch.device("cuda", 0) if device.startswith("cuda") else torch.device("cpu")
        if dev.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        pin_fp32()
        arrays = sweep_arrays(dev)
        mesh = make_mesh(MeshSpec(data=world, sample=1), dev.type)
        g = torch.Generator(device=dev).manual_seed(1)
        field = build_model(cfg, g, dev)
        epoch_fn = make_sharded_epoch_fn(
            cfg, field, make_optimizer(cfg, field.parameters()), mesh, steps, g,
            n_rays=cfg["train"]["n_rays"], n_batch=1, use_mask=False)
        order = (torch.arange(steps, device=dev) % N_VIEWS)[:, None]
        losses = epoch_fn(arrays, order, 0).cpu()       # warm-up
        times = []
        for i in range(TIMED_EPOCHS):
            dist.barrier()
            t0 = time.perf_counter()
            losses = epoch_fn(arrays, order, (i + 1) * steps).cpu()
            times.append(time.perf_counter() - t0)
        return {"rank": rank, "times_s": times, "losses": losses.tolist()}
    finally:
        dist.destroy_process_group()


def sweep(device: str, sizes: Sequence[int], n_rays: int, n_samples: int,
          log2_table: int, steps: int, backward: str) -> List[Dict[str, Any]]:
    """One row a mesh size: rays/s of the best timed epoch on rank 0 and
    the efficiency against the first size's rate."""
    from multiprocess_smoke_torch import free_port, run_ranks

    cfg = sweep_cfg(n_rays, n_samples, log2_table, backward)
    rows, base_rate = [], None
    for n in sizes:
        ranks = run_ranks(sweep_rank, n, (n, free_port(), device, cfg, steps))
        losses = [x for r in ranks for x in r["losses"]]
        if not np.isfinite(losses).all():
            raise RuntimeError(f"{n} ranks: losses not finite: {losses}")
        rate = steps * n_rays / min(ranks[0]["times_s"])
        if base_rate is None:
            base_rate = rate
        rows.append({"ranks": n, "rays_per_s": round(rate, 1),
                     "efficiency_vs_1rank": round(efficiency(rate, base_rate, n), 3)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def report(rows: List[Dict[str, Any]], args, card: str) -> str:
    where = ("gloo ranks sharing cuda:0: contention on one card, not scaling"
             if args.device == "cuda" else
             "gloo ranks on the CPU, sharing the host's cores: the numbers check the "
             "plumbing, not the collective layer")
    lines = ["# Scaling sweep: sharded epoch (`scripts/scaling_sweep_torch.py`)", "",
             f"Device: {args.device} ({card}); {where}. Global batch {args.n_rays} rays x "
             f"{args.n_samples} samples; 2^{args.log2_table} table; backward="
             f"{args.backward}; {args.steps}-step epochs, the best of {TIMED_EPOCHS} "
             "(rank 0's clock) after a warm-up epoch; one process a rank.", "",
             "| ranks | rays/s | efficiency vs 1 rank |", "|---|---|---|"]
    lines += [f"| {r['ranks']} | {r['rays_per_s']:,} | {r['efficiency_vs_1rank']:.1%} |"
              for r in rows]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="where the ranks run: sharing cuda:0 (default), or the CPU")
    p.add_argument("--n-rays", type=int, default=1024)
    p.add_argument("--n-samples", type=int, default=64)
    p.add_argument("--log2-table", type=int, default=15)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--backward", default="take",
                   help="encoder backward: 'take' (no kernel) | 'bucket'")
    p.add_argument("--out", default=None, help="default: docs/scaling_sweep_torch_"
                                               "{card,cpu}.md by --device")
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from real_scale_train_r5_torch import card_line

    if args.device == "cuda":
        from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
            resolve_device)
        resolve_device("cuda")
    rows = sweep(args.device, SIZES, args.n_rays, args.n_samples, args.log2_table,
                 args.steps, args.backward)
    out = args.out or OUT[args.device]
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(report(rows, args, card_line(args.device)))
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
