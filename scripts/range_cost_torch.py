#!/usr/bin/env python3
"""What the marked twin of the graphed training step costs, on the card.

``train/trainer.py::_GraphedStep`` replays a marked twin of the step (the
plain step with its layer ranges' marks, ``utils/profiling.py``) while a
profiler runs or inside ``profiling.ranges()``.  This script builds the
program for a cell of the benchmark (``portbench/``: its configuration,
scan, weights and fed draws, as a run of the cell builds them), runs the
first epoch, and then times alternating blocks of whole epochs with
``StepTimer`` and no profiler: plain replays, then replays inside
``profiling.ranges()``.  It prints, for each kind, the median over blocks
of the mean and of the median step time, the marked step's cost against
the plain one, and the layer ranges of the last marked block
(``range_totals()``: device ms a step).

Run from the repository root on a machine with a CUDA card:

    python3 scripts/range_cost_torch.py [--workload chest_50.r1024] [--seed 1]
        [--blocks 8] [--epochs 4]

The last line of standard output is the result as JSON.  Imports nothing
of JAX.
"""

import argparse
import contextlib
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cost(cell, seed: int, device: torch.device, blocks: int, epochs: int) -> dict:
    """Alternating blocks of ``epochs`` epochs, plain then marked, ``blocks``
    of each, on the program built for ``cell``."""
    import run

    from neuralvolumetricreconstructionformedicalimages_torch.utils import profiling

    s = run.set_up(run.import_program(), cell, seed, device)
    program, order, draws = s.program, s.order, s.draws
    spe = program.steps_per_epoch
    program.epoch(order, run.CHECK_STEPS, draws, run.CHECK_STEPS, spe)
    start = spe
    kinds = {"plain": [], "marked": []}
    ranges = None
    for b in range(2 * blocks):
        kind = "marked" if b % 2 else "plain"
        timer = run.StepTimer(device)
        timer.tick()
        with profiling.ranges() if kind == "marked" else contextlib.nullcontext():
            for _ in range(epochs):
                program.epoch(order, start, draws, 0, spe, timer)
                start += spe
        ms = timer.step_ms()
        kinds[kind].append((statistics.fmean(ms), statistics.median(ms)))
        if kind == "marked":
            ranges = profiling.range_totals(device)
    out = {"workload": cell.name, "seed": seed, "blocks": blocks,
           "steps_per_block": epochs * spe}
    for kind, rows in kinds.items():
        out[f"{kind}_mean_ms"] = statistics.median(r[0] for r in rows)
        out[f"{kind}_median_ms"] = statistics.median(r[1] for r in rows)
        out[f"{kind}_block_mean_ms"] = [r[0] for r in rows]
    out["cost_mean"] = out["marked_mean_ms"] / out["plain_mean_ms"] - 1
    out["cost_median"] = out["marked_median_ms"] / out["plain_median_ms"] - 1
    steps = ranges["steps"]
    out["marked_steps"] = steps
    out["range_ms"] = {r: ms / steps for r, ms in ranges["device_ms"].items()
                       if steps and ranges["hits"][r]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="chest_50.r1024")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("range_cost_torch: no CUDA device available", file=sys.stderr)
        return 1
    os.chdir(ROOT)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "portbench")]
    import run

    dev = torch.device("cuda", 0)
    out = cost(run.load_cell(args.workload), args.seed, dev, args.blocks, args.epochs)
    out["card"] = torch.cuda.get_device_name(dev)
    print(f"{out['workload']} on {out['card']}: step {out['plain_mean_ms']:.4f} ms plain, "
          f"{out['marked_mean_ms']:.4f} ms marked (mean a step, median of "
          f"{args.blocks} blocks of {out['steps_per_block']}): {100 * out['cost_mean']:+.2f} %; "
          f"medians {out['plain_median_ms']:.4f} / {out['marked_median_ms']:.4f} ms: "
          f"{100 * out['cost_median']:+.2f} %")
    for r, ms in out["range_ms"].items():
        print(f"{ms:10.4f} ms  {r}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
