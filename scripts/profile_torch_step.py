#!/usr/bin/env python3
"""Where the time of a training step of the PyTorch port goes, on the card.

Builds the port's ``Trainer`` for a config (default
``configs/chest_phantom_r3.yaml``: 1024 rays x 192 samples, 16 x 2^19 x 2
table) and profiles its steps one of two ways:

- by default the graphed epoch (``Trainer.train_steps``: the epoch
  function's one eager step and capture, then replays of the captured
  step);
- with ``--eager`` the eager loop (``Trainer.train_step``, step by step).

It runs ``--warmup`` steps (for the graphed epoch: the eager step, the
capture and replays), then prints:

- the wall time per step of an unprofiled window (host clock around
  ``--steps`` steps, ending in a synchronize) and the summed device kernel
  time per step of the profiled window;
- the device idle share, 1 - kernel time / unprofiled wall time (the
  kernels of one stream do not overlap; the profiler's own host overhead
  would inflate the profiled window's wall time);
- device time by kernel name (top ``--top``), with the four encoder
  kernels of ``csrc/`` marked;
- the number of kernel launches per step (for the graphed epoch, the
  kernels that the replays ran);
- the peak device memory from the trainer's first step on
  (``torch.cuda.max_memory_allocated`` after a reset; the graph's private
  pool is counted while it is allocated, at the capture) and the memory
  reserved at the end;
- the host syncs of 5 more steps on a view order already
  on the device (``torch.cuda.set_sync_debug_mode("warn")``), per step, by
  the line of the port that made them and with the innermost frame: at
  each, the host waits for the device to drain, and the device then idles
  while the host queues the next launches.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/profile_torch_step.py [--eager] [--config ...] [--steps 20]
        [--out DIR] [--encoder hash_variant=xor ...] [--force-mesh]

Compare the two in one call, in ABBA order (graph, eager, eager, graph),
as four runs of the script.  ``--encoder KEY=VALUE`` (repeatable)
overrides a key of the config's ``encoder`` section, to profile another
encoder path.  ``--force-mesh`` profiles the sharded epoch of
``parallel/step.py`` on a mesh of one (a one-rank NCCL group the trainer
makes): graphed like the plain epoch, or with ``--eager`` its eager step
loop.

``--out`` also writes the chrome trace there.  Imports nothing of JAX.
"""

import argparse
import collections
import json
import os
import sys
import time
import traceback
import warnings

import numpy as np
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODER_KERNELS = ("roll_broadcast_kernel", "unroll_reduce_kernel",
                   "span_gather_kernel", "bucket_kernel")
# steps run under the sync check, after the profiled window
SYNC_STEPS = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/chest_phantom_r3.yaml")
    ap.add_argument("--eager", action="store_true",
                    help="the eager step loop in place of the graphed epoch")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None)
    ap.add_argument("--encoder", action="append", default=[], metavar="KEY=VALUE",
                    help="override an encoder config key (repeatable)")
    ap.add_argument("--force-mesh", action="store_true",
                    help="the sharded epoch on a one-rank mesh")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device available", file=sys.stderr)
        return 1
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from neuralvolumetricreconstructionformedicalimages_torch.config import load_config
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    cfg["log"].update(i_eval=0, i_save=0)
    for item in args.encoder:
        key, _, value = item.partition("=")
        cfg["encoder"][key] = yaml.safe_load(value)
    if args.force_mesh:
        cfg["parallel"] = {"mesh": {"data": 1, "sample": 1}, "force_mesh": True}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, workdir=os.path.join("logs", "profile_torch_step"), device="cuda")
    try:
        return profile(tr, args)
    finally:
        tr.close()


def sync_sites(run):
    """Run ``run()`` with the card's sync debug mode at "warn"; return
    (site -> count, innermost frame -> count), a site being the innermost
    frame in this repository outside this script."""
    here = os.path.abspath(__file__)
    sites, inner = collections.Counter(), collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        # the sync debug mode's own notice on being set is not a sync
        if "called a synchronizing" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        own = [f for f in stack if f.filename.startswith(ROOT) and f.filename != here]
        site = own[-1] if own else stack[-1]
        sites[f"{os.path.relpath(site.filename, ROOT)}:{site.lineno}"] += 1
        inner[f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites, inner


def profile(tr, args) -> int:
    n = args.warmup + 2 * args.steps + SYNC_STEPS
    order = np.resize(tr._view_order(0).reshape(-1, tr.n_batch), (n, tr.n_batch))
    order_dev = torch.as_tensor(order, device=tr.device)
    windows = np.cumsum([0, args.warmup, args.steps, args.steps, SYNC_STEPS])

    def run(w):
        part = order_dev[windows[w]:windows[w + 1]]
        if args.eager:
            for views in part:
                tr.train_step(views)
        else:
            tr.train_steps(part)

    run(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    reserved_mb = torch.cuda.memory_reserved() / 1e6

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(2)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    sites, inner = sync_sites(lambda: run(3))
    n_syncs = sum(sites.values()) / SYNC_STEPS

    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        device_kernels)
    rows = [(k, ms / args.steps, n / args.steps)
            for k, (ms, n) in device_kernels(prof).items()]
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    mode = "eager loop" if args.eager else "graphed epoch"
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"config: {args.config} {' '.join(args.encoder)}"
          f"{' force_mesh' if args.force_mesh else ''}, {mode}, {args.steps} profiled "
          f"steps after {args.warmup} warm-up")
    print(f"[{mode}] wall per step: {wall_ms:.3f} ms unprofiled, {prof_wall_ms:.3f} ms "
          f"profiled; device kernel time per step: {dev_ms:.3f} ms; "
          f"device idle share: {1 - dev_ms / wall_ms:.3f}; kernel launches per step: "
          f"{launches:.0f}; peak device memory (max_memory_allocated): "
          f"{peak_mb:.1f} MB, reserved {reserved_mb:.1f} MB")
    print(f"[{mode}] host syncs per step: {n_syncs:g} over {SYNC_STEPS} steps "
          f"({', '.join(f'{k} x{n}' for k, n in sites.most_common())}; innermost "
          f"frames: {', '.join(f'{k} x{n}' for k, n in inner.most_common())})")
    enc_ms = sum(r[1] for r in rows if any(k in r[0] for k in ENCODER_KERNELS))
    print(f"four encoder kernels: {enc_ms:.3f} ms per step "
          f"({enc_ms / dev_ms:.3f} of device time)")
    print(f"{'device ms/step':>14} {'calls/step':>10}  kernel")
    for name, ms, k in rows[: args.top]:
        mark = " *" if any(e in name for e in ENCODER_KERNELS) else ""
        print(f"{ms:14.4f} {k:10.1f}  {name[:110]}{mark}")
    summary = {"config": args.config, "encoder": args.encoder, "mode": mode,
               "force_mesh": args.force_mesh, "steps": args.steps,
               "wall_ms_per_step": wall_ms,
               "profiled_wall_ms_per_step": prof_wall_ms,
               "device_ms_per_step": dev_ms, "device_idle_share": 1 - dev_ms / wall_ms,
               "launches_per_step": launches, "peak_memory_mb": peak_mb,
               "reserved_memory_mb": reserved_mb,
               "host_syncs_per_step": n_syncs, "host_sync_sites": dict(sites),
               "host_sync_innermost": dict(inner),
               "encoder_kernels_ms_per_step": enc_ms,
               "card": torch.cuda.get_device_name(0),
               "top": [{"kernel": n, "ms_per_step": m, "calls_per_step": c}
                       for n, m, c in rows[: args.top]]}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "top"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
