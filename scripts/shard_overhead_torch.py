#!/usr/bin/env python3
"""One-card stand-ins for the multi-card scaling axis.

The port of ``scripts/shard_overhead.py``: what can be measured on one
card about the mesh.

1. The mesh's cost: the chest-scale step (``configs/chest_50.yaml`` at
   1024 rays x 192 samples, 8-step epochs over 50 random views of 256^2)
   through the plain epoch function (``train/trainer.py::make_epoch_fn``:
   one CUDA graph replayed step by step) against a mesh of one
   (``parallel/step.py::make_sharded_epoch_fn`` on a one-rank group: NCCL
   on the card, where it too is one captured step replayed; gloo on the
   CPU, eager).  On the card both are graphed, so the difference is the
   mesh's structure alone: the flat gradient's concatenation, the
   all-reduces and their stream joins.  Beside them the same mesh's eager
   step (``make_sharded_train_step`` step by step), the figure before the
   sharded step was captured.
2. The gradient all-reduce: its payload (every parameter in f32) and the
   measured time of one all-reduce of that payload, on the one-rank group
   and across two gloo ranks (sharing ``cuda:0`` on the card: NCCL
   refuses two ranks on one card).  No link rate is taken from a data
   sheet.

The JAX script's ``_check_vma`` check is not carried over: it checks
Mosaic's compiled Pallas kernels, which the port does not have.

    python3 scripts/shard_overhead_torch.py [--steps 8] [--device cpu] [--out PATH]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.  Writes ``docs/scaling_standin_torch.md``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS, N_SAMPLES, STEPS = 1024, 192, 8
TIMED_EPOCHS = 3
AR_ITERS = 10
OUT = "docs/scaling_standin_torch.md"


def chest_cfg(n_rays: int = N_RAYS, n_samples: int = N_SAMPLES) -> Dict[str, Any]:
    """``configs/chest_50.yaml`` at ``n_rays`` x ``n_samples``."""
    from neuralvolumetricreconstructionformedicalimages_torch.config import (
        load_config, with_defaults)
    cfg = with_defaults(load_config("configs/chest_50.yaml"))
    cfg["render"]["n_samples"] = n_samples
    cfg["train"]["n_rays"] = n_rays
    return cfg


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(make_fn: Callable, cfg, arrays, device, steps: int) -> Dict[str, float]:
    """A fresh field and Adam, ``make_fn(field, optimizer, generator)``'s
    epoch function (``fn(arrays, view_order, start_step) -> losses``) run
    once (warm-up: the eager step and the capture) and ``TIMED_EPOCHS``
    times more; the best epoch's ms a step."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.train.optim import (
        make_optimizer)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        build_model)
    g = torch.Generator(device=device).manual_seed(1)
    field = build_model(cfg, g, device)
    fn = make_fn(field, make_optimizer(cfg, field.parameters()), g)
    n_views = arrays["projs"].shape[0]
    order = (torch.arange(steps, device=device) % n_views)[:, None]
    sync(device)
    t0 = time.perf_counter()
    losses = fn(arrays, order, 0).cpu()
    warm = time.perf_counter() - t0
    ts = []
    for i in range(TIMED_EPOCHS):
        sync(device)
        t0 = time.perf_counter()
        losses = fn(arrays, order, (i + 1) * steps).cpu()
        sync(device)
        ts.append(time.perf_counter() - t0)
    if not torch.isfinite(losses).all():
        raise RuntimeError(f"losses not finite: {losses.tolist()}")
    best = min(ts) / steps
    return {"ms_per_step": best * 1e3, "rays_per_s": cfg["train"]["n_rays"] / best,
            "warm_s": warm, "n_params": sum(p.numel() for p in field.parameters())}


def allreduce_ms(n: int, device, iters: int = AR_ITERS) -> float:
    """Median ms of one SUM all-reduce of ``n`` f32 over the default group
    (host clock, the card synchronised before and after each)."""
    import torch
    import torch.distributed as dist

    buf = torch.zeros(n, device=device)
    times = []
    for i in range(iters + 2):
        sync(device)
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        sync(device)
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _allreduce_rank(rank: int, world: int, port: int, device: str, n: int) -> float:
    import torch.distributed as dist
    from multiprocess_smoke_torch import join_group

    join_group(rank, world, port, device)
    try:
        return allreduce_ms(n, "cuda:0" if device.startswith("cuda") else "cpu")
    finally:
        dist.destroy_process_group()


def run(device, steps: int = STEPS, cfg: Optional[Dict[str, Any]] = None,
        **scan) -> Dict[str, Any]:
    """The plain and the mesh-of-one epoch's ms a step on ``cfg`` (default
    :func:`chest_cfg`) and the scan of ``batch_sweep_torch.scan_arrays(
    **scan)`` (the JAX script's 50 random views of 256^2), and the
    gradient all-reduce's payload and measured times."""
    import torch
    import torch.distributed as dist

    from batch_sweep_torch import scan_arrays
    from multiprocess_smoke_torch import free_port, run_ranks
    from neuralvolumetricreconstructionformedicalimages_torch.parallel import (
        MeshSpec, initialize_multihost, make_mesh, make_sharded_epoch_fn,
        make_sharded_train_step)
    from neuralvolumetricreconstructionformedicalimages_torch.parallel.step import (
        graphs_collectives)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        make_epoch_fn, pin_fp32, resolve_device)
    dev = resolve_device(device)
    pin_fp32()
    cfg = cfg or chest_cfg()
    arrays = scan_arrays(dev, **scan)
    n_rays = cfg["train"]["n_rays"]
    rec: Dict[str, Any] = {"device": str(dev), "n_rays": n_rays, "steps": steps,
                           "n_samples": cfg["render"]["n_samples"],
                           "views": int(arrays["projs"].shape[0]),
                           "detector": list(arrays["projs"].shape[1:])}
    rec["plain"] = measure(
        lambda f, o, g: make_epoch_fn(cfg, f, o, steps, n_rays=n_rays, n_batch=1,
                                      use_mask=False, generator=g),
        cfg, arrays, dev, steps)
    initialize_multihost(f"localhost:{free_port()}", 1, 0, device=dev)
    try:
        mesh = make_mesh(MeshSpec(data=1, sample=1), dev.type)
        kw = dict(n_rays=n_rays, n_batch=1, use_mask=False)
        rec["mesh1"] = measure(
            lambda f, o, g: make_sharded_epoch_fn(cfg, f, o, mesh, steps, g, **kw),
            cfg, arrays, dev, steps)
        rec["mesh1_graphed"] = graphs_collectives(dev)

        def eager_epoch(f, o, g):
            step = make_sharded_train_step(cfg, f, o, mesh, steps, g, **kw)
            return lambda arrays, order, start: torch.stack(
                [step(arrays, v, start + i) for i, v in enumerate(order)])

        rec["mesh1_eager"] = measure(eager_epoch, cfg, arrays, dev, steps)
        n = rec["plain"]["n_params"]
        rec["backend_1rank"] = dist.get_backend()
        rec["allreduce_1rank_ms"] = allreduce_ms(n, dev)
    finally:
        dist.destroy_process_group()
    del arrays
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gloo = run_ranks(_allreduce_rank, 2, (2, free_port(), dev.type, n))
    rec["allreduce_2rank_gloo_ms"] = max(gloo)
    rec["payload_mib"] = n * 4 / 2 ** 20
    for name in ("mesh1", "mesh1_eager"):
        over = rec[name]["ms_per_step"] - rec["plain"]["ms_per_step"]
        rec[name]["overhead_ms"] = over
        rec[name]["overhead_pct"] = 100 * over / rec["plain"]["ms_per_step"]
    return rec


def report(rec: Dict[str, Any], card: str) -> str:
    p, m, e = rec["plain"], rec["mesh1"], rec["mesh1_eager"]
    where = ("two gloo ranks sharing cuda:0 (host-staged)" if rec["device"].startswith("cuda")
             else "two gloo ranks on the CPU")
    how = "graphed" if rec["mesh1_graphed"] else f"eager under {rec['backend_1rank']}"
    if rec["mesh1_graphed"]:
        why = ("Both the plain and the mesh's epoch replay one captured CUDA graph a "
               "step, so this is the mesh's structure alone: the flat gradient's "
               "concatenation, the all-reduces and their stream joins.")
    else:
        why = (f"Under {rec['backend_1rank']} the sharded step is not captured (gloo "
               "stages its collectives through the host), so the mesh's epoch is eager.")
    return "\n".join([
        "# Mesh overhead on one device (`scripts/shard_overhead_torch.py`)", "",
        f"Device: {rec['device']} ({card}). `configs/chest_50.yaml` at {rec['n_rays']} "
        f"rays x {rec['n_samples']} samples, {rec['views']} random views of "
        f"{rec['detector'][0]}x{rec['detector'][1]}, {rec['steps']}-step epochs, the best "
        f"of {TIMED_EPOCHS} after a warm-up epoch.", "",
        "| step | ms a step | rays/s | warm-up s | against plain |", "|---|---|---|---|---|",
        f"| plain (`make_epoch_fn`, graphed on the card) | {p['ms_per_step']:.3f} | "
        f"{p['rays_per_s']:,.0f} | {p['warm_s']:.2f} | |",
        f"| mesh of one, {how} (`make_sharded_epoch_fn`, {rec['backend_1rank']}) | "
        f"{m['ms_per_step']:.3f} | {m['rays_per_s']:,.0f} | {m['warm_s']:.2f} | "
        f"{m['overhead_ms']:+.3f} ms ({m['overhead_pct']:+.1f} %) |",
        f"| mesh of one, eager (`make_sharded_train_step` step by step) | "
        f"{e['ms_per_step']:.3f} | {e['rays_per_s']:,.0f} | {e['warm_s']:.2f} | "
        f"{e['overhead_ms']:+.3f} ms ({e['overhead_pct']:+.1f} %) |", "",
        f"Mesh overhead: {m['overhead_ms']:+.3f} ms a step ({m['overhead_pct']:+.1f} % "
        f"of the plain step). {why}", "",
        f"Gradient all-reduce: {rec['plain']['n_params']:,} f32 parameters, "
        f"{rec['payload_mib']:.1f} MiB a step. Measured (median of {AR_ITERS}): "
        f"{rec['allreduce_1rank_ms']:.3f} ms on the one-rank {rec['backend_1rank']} "
        f"group, {rec['allreduce_2rank_gloo_ms']:.3f} ms across {where} (the slower "
        "rank). No link rate is quoted: no call has had two cards.", ""])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from real_scale_train_r5_torch import card_line

    rec = run(args.device, args.steps)
    text = report(rec, card_line(rec["device"]))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
