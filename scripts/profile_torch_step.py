#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on the card.

Builds the port's ``Trainer`` for a config (default
``configs/chest_phantom_r3.yaml``: 1024 rays x 192 samples, 16 x 2^19 x 2
table), runs warm-up steps, then profiles ``--steps`` steps with
``torch.profiler`` and prints:

- the wall time per step of an unprofiled window (host clock around
  ``--steps`` steps, ending in a synchronize) and the summed device kernel
  time per step of the profiled window;
- the device idle share, 1 - kernel time / unprofiled wall time (the
  kernels of one stream do not overlap; the profiler's own host overhead
  would inflate the profiled window's wall time);
- device time by kernel name (top ``--top``), with the four encoder
  kernels of ``csrc/`` marked;
- the number of kernel launches per step.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/profile_torch_step.py [--config ...] [--steps 20] [--out DIR]
        [--encoder hash_variant=xor ...]

``--encoder KEY=VALUE`` (repeatable) overrides a key of the config's
``encoder`` section, to profile another encoder path.

``--out`` also writes the chrome trace there.  Imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import time

import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODER_KERNELS = ("roll_broadcast_kernel", "unroll_reduce_kernel",
                   "span_gather_kernel", "bucket_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/chest_phantom_r3.yaml")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None)
    ap.add_argument("--encoder", action="append", default=[], metavar="KEY=VALUE",
                    help="override an encoder config key (repeatable)")
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
    tr = Trainer(cfg, workdir=os.path.join("logs", "profile_torch_step"), device="cuda")
    views = tr._view_order(0).reshape(-1, tr.n_batch)
    for i in range(args.warmup):
        tr.train_step(views[i % len(views)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.steps):
        tr.train_step(views[i % len(views)])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            tr.train_step(views[i % len(views)])
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if getattr(ev, "is_user_annotation", False):  # ranges such as Optimizer.step
            continue
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us / 1e3 / args.steps, ev.count / args.steps))
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"config: {args.config} {' '.join(args.encoder)}, {args.steps} profiled "
          f"steps after {args.warmup} warm-up")
    print(f"wall per step: {wall_ms:.3f} ms unprofiled, {prof_wall_ms:.3f} ms profiled; "
          f"device kernel time per step: {dev_ms:.3f} ms; "
          f"device idle share: {1 - dev_ms / wall_ms:.3f}; kernel launches per step: "
          f"{launches:.0f}")
    enc_ms = sum(r[1] for r in rows if any(k in r[0] for k in ENCODER_KERNELS))
    print(f"four encoder kernels: {enc_ms:.3f} ms per step "
          f"({enc_ms / dev_ms:.3f} of device time)")
    print(f"{'device ms/step':>14} {'calls/step':>10}  kernel")
    for name, ms, n in rows[: args.top]:
        mark = " *" if any(k in name for k in ENCODER_KERNELS) else ""
        print(f"{ms:14.4f} {n:10.1f}  {name[:110]}{mark}")
    summary = {"config": args.config, "encoder": args.encoder, "steps": args.steps,
               "wall_ms_per_step": wall_ms,
               "profiled_wall_ms_per_step": prof_wall_ms,
               "device_ms_per_step": dev_ms, "device_idle_share": 1 - dev_ms / wall_ms,
               "launches_per_step": launches, "encoder_kernels_ms_per_step": enc_ms,
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
