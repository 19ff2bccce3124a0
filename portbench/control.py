#!/usr/bin/env python3
"""The readings that a cell's limits for ``correct`` are set from.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... [--out FILE]

For each seed, at the cell's own size and on its card, one process reads
the numbers that ``run.py`` compares (``reference.compare``) three ways
against the configuration's plain reference (``cell.reference``) in f32:

- ``program``: the program's first steps, as a run takes them (the lower
  readings: the largest over the seeds);
- ``control``: the reference in the program's place, every GEMM in TF32,
  the precision below the configuration's f32 with TF32 off;
- ``half_batch``: the reference in the program's place with half of the
  batch left out of the loss and the mean taken over the rest.

(A step that leaves the state unchanged reads 1 by ``change_gap`` and
needs no run.)  Prints one JSON line a seed and then a summary: the
largest program reading and the smallest control and fault readings of
each number.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

import torch

import reference
import run

VARIANTS = {"control": {"tf32": True}, "half_batch": {"keep": 0.5}}


def seed_readings(prog, cell, seed: int, device: torch.device) -> Dict[str, Dict]:
    """The gaps of the program, the control and the fault against the
    reference, for one seed."""
    s = run.set_up(prog, cell, seed, device)
    spe = s.program.steps_per_epoch
    del s.program
    run.free(device)
    proj, weights, draws = run.reference_inputs(cell, seed, device, s)

    def readings(**kw):
        return cell.reference.reference_readings(cell.cfg, proj, weights, draws, s.order,
                                                 steps=run.CHECK_STEPS, steps_per_epoch=spe,
                                                 **kw)

    ref = readings()
    out = {"program": reference.compare(s.readings, ref)}
    for name, kw in VARIANTS.items():
        out[name] = reference.compare(readings(**kw), ref)
    return out


def summary(rows: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Each number's largest program reading and smallest control and
    fault readings over the seeds."""
    keys = rows[0]["program"].keys()
    out = {"program_max": {k: max(r["program"][k] for r in rows) for k in keys}}
    for name in VARIANTS:
        out[f"{name}_min"] = {k: min(r[name][k] for r in rows) for k in keys}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device available", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    prog = run.import_program()
    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        row = {"seed": seed, **seed_readings(prog, cell, seed, device)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    summ = {"workload": cell.name, "card": torch.cuda.get_device_name(0),
            **summary(rows)}
    print(json.dumps(summ))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summ}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
