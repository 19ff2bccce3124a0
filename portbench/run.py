#!/usr/bin/env python3
"""One run of one cell of the benchmark of the PyTorch and CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card.  The
cell (``BENCHMARK.json``) names a configuration (``configs/<name>.json``:
the model, the scan and its phantom) and a traffic mix
(``traffic/<name>.json``: rays and views a step); its limits for
``correct`` are ``limits/<cell>.json``.

Set-up makes the scan, the weights and the draws from ``--seed``, builds
the program as its trainer does (``data/dataset.py::make_dataset``,
``train/trainer.py::build_model``, ``train/optim.py::make_optimizer``,
``train/trainer.py::make_epoch_fn``), and runs the epoch function's first
steps (its eager step, its capture, replays) with the draws fed, keeping
what the comparison reads, and the rest of the first epoch.  Then:

- ``--trace 0`` runs whole epochs of graphed replays for ``--seconds``
  seconds, ending in one synchronize, and reports the end-to-end metrics;
- ``--trace 1`` traces a block of whole epochs under ``torch.profiler``,
  their draws made before it starts, and reports the per-layer metrics
  (``metrics/<name>``) and a breakdown.

The window feeds each epoch's draws (made from the seed between epochs),
as the compared steps are fed: the timed graph is the epoch function's
graph with fed draws.

Then the program's state is freed and the configuration's plain reference
(the module its key ``reference`` names, ``reference.py`` without the key)
follows the first steps on the card; ``correct`` holds
when each number compared lies within its limit and no loss of the window
was non-finite.  The last line of standard output is the result, as JSON,
printed only when no module of JAX or of the JAX package is loaded by then.

Writes nothing but the program's own kernel build (``build/`` in the
checkout).  Without a card, or in a checkout without the program, it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import os
import time


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (0 where it
    cannot be read: the clock then starts here)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# The process's start on this clock: set-up is timed from it.
_T_START = time.perf_counter() - process_age_s()

import argparse  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import ModuleType, SimpleNamespace  # noqa: E402
from typing import Dict, List, Tuple  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import counts  # noqa: E402
import reference  # noqa: E402
import trace_reader  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "neuralvolumetricreconstructionformedicalimages_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "neuralvolumetricreconstructionformedicalimages_tpu")
# The steps the reference follows, and the epochs a traced run traces.
CHECK_STEPS = 3
TRACE_EPOCHS = 4
# What a configuration's own plain reference supplies.  The seeded streams,
# the draws and the judging (``generator``, ``draw_epoch``, ``compare``,
# ``norms``, ``change_norms``) are always ``reference.py``'s, so that every
# cell is judged alike.
REFERENCE_API = ("make_scan", "make_weights", "layer_dims", "corner_rows",
                 "reference_readings")


# --------------------------------------------------------------------------
# The cell
# --------------------------------------------------------------------------

def load_reference(config: str, cfg: Dict) -> ModuleType:
    """The plain reference of configuration ``config``: the module whose
    path, relative to the harness's folder, its file ``cfg`` gives under
    ``reference``, loaded by path once per process under a name of its
    own; ``reference.py`` itself where the key is absent."""
    rel = cfg.get("reference")
    if rel is None:
        return reference
    where = f"configuration {config!r}, key 'reference' ({rel!r})"
    if not isinstance(rel, str) or not rel:
        raise ValueError(f"{where}: not a path")
    if Path(rel).is_absolute() or ".." in Path(rel).parts:
        raise ValueError(f"{where}: not a relative path inside {HERE.name}/")
    path = (HERE / rel).resolve()
    if not path.is_relative_to(HERE):
        raise ValueError(f"{where}: resolves to {path}, outside {HERE.name}/")
    if not path.is_file():
        raise FileNotFoundError(f"{where}: no file {path}")
    mod_name = (f"portbench_reference_{path.stem}_"
                f"{hashlib.sha1(str(path).encode()).hexdigest()[:12]}")
    mod = sys.modules.get(mod_name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        try:
            spec.loader.exec_module(mod)
        except Exception as exc:
            del sys.modules[mod_name]
            raise ImportError(f"{where}: loading it raised {exc!r}") from exc
    missing = [n for n in REFERENCE_API if not callable(getattr(mod, n, None))]
    if missing:
        raise ImportError(f"{where}: the module lacks {', '.join(missing)}")
    return mod


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    its plain reference (``load_reference``), traffic, limits and
    metrics."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        cfg = json.load(f)
    ref = load_reference(conf["name"], cfg)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return SimpleNamespace(name=name, chips=int(cell["chips"]), cfg=cfg, reference=ref,
                           traffic=traffic, limits=limits, metrics_dir=HERE / "metrics",
                           end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                           per_layer=[m for m in bench["per_layer"] if mine(m)])


def import_program(root: Path = ROOT) -> SimpleNamespace:
    """The program's modules, imported from the checkout at ``root`` (and
    from nowhere else)."""
    pkg = root / PROGRAM
    if not (pkg / "__init__.py").is_file():
        raise FileNotFoundError(f"the program {PROGRAM} is not in {root}")
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    mod = importlib.import_module(PROGRAM)
    if Path(mod.__file__).resolve().parent != pkg.resolve():
        raise ImportError(f"{PROGRAM} was imported from {mod.__file__}, not {pkg}")
    sub = {k: importlib.import_module(f"{PROGRAM}.{p}") for k, p in (
        ("config", "config"), ("dataset", "data.dataset"),
        ("trainer", "train.trainer"), ("optim", "train.optim"))}
    return SimpleNamespace(**sub)


def program_config(cell) -> Dict:
    """The program's configuration: the cell's file with the traffic's
    rays and views a step."""
    cfg = {k: json.loads(json.dumps(cell.cfg[k]))
           for k in ("exp", "network", "encoder", "render", "train", "log")}
    cfg["train"]["n_rays"] = int(cell.traffic["n_rays"])
    cfg["train"]["n_batch"] = int(cell.traffic["n_batch"])
    return cfg


# --------------------------------------------------------------------------
# The program under test
# --------------------------------------------------------------------------

class StepTimer:
    """Step times from marks at step boundaries (``utils/profiling.py::
    StepTimer``'s method): CUDA events recorded in the stream, read after
    one wait; the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def tick(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> List[float]:
        m = self.marks
        if self.cuda and m:
            m[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(m[:-1], m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m[:-1], m[1:])]


class MeasurementError(RuntimeError):
    """The run cannot be measured as the benchmark defines it."""


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The program's training state, built from the benchmark's scan and
    weights as its trainer builds it, and its epoch function."""

    def __init__(self, prog, cell, data: Dict, weights: Dict[str, torch.Tensor],
                 seed: int, device: torch.device):
        self.device = device
        self.cfg = prog.config.with_defaults(program_config(cell))
        tr = self.cfg["train"]
        self.n_rays, self.n_batch = int(tr["n_rays"]), int(tr["n_batch"])
        prog.trainer.pin_fp32()
        dset = prog.dataset.make_dataset(data, "train", self.n_rays, device=device)
        self.arrays = dset.arrays()
        self.steps_per_epoch = max(1, dset.n_views // self.n_batch)
        use_mask = bool(float(dset.mask.min()) < 1.0)
        # The trainer's generator: its draws are replaced by the fed ones.
        gen = reference.generator(seed, reference.PROGRAM, device)
        self.field = prog.trainer.build_model(self.cfg, gen, device)
        with torch.no_grad():
            for name, p in self.field.named_parameters():
                p.copy_(weights[name])
        self.optimizer = prog.optim.make_optimizer(self.cfg, list(self.field.parameters()))
        self.fn = prog.trainer.make_epoch_fn(
            self.cfg, self.field, self.optimizer, self.steps_per_epoch,
            n_rays=self.n_rays, n_batch=self.n_batch, use_mask=use_mask,
            generator=gen, geo=dset.geo, near=dset.near, far=dset.far)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.field.named_parameters())

    def epoch(self, order, start, draws, lo: int, hi: int, timer=None):
        """Steps ``lo`` to ``hi`` of an epoch through the epoch function."""
        fed = {k: draws[k][lo:hi] for k in ("r", "t_rand")}
        return self.fn(self.arrays, order[lo:hi], start, draws=fed, timer=timer)

    def first_steps(self, order, draws, steps: int) -> Dict:
        """Steps 1 to ``steps`` of the first epoch (one eager step and its
        capture, then replays), with the readings the comparison takes:
        each loss, each leaf's first gradient from Adam's state after one
        step (its first moment over 1 - beta1), each leaf's change after
        the last."""
        before = {k: v.detach().cpu().numpy().copy() for k, v in self.params().items()}
        losses = [self.epoch(order, 0, draws, 0, 1)]
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        first = {}
        for k, p in self.params().items():
            m = self.optimizer.state.get(p, {}).get("exp_avg")
            first[k] = (reference.norms({k: m})[k] / (1 - beta1) if m is not None else 0.0)
        losses.append(self.epoch(order, 1, draws, 1, steps))
        change = reference.change_norms(self.params(), before)
        loss = torch.cat(losses).cpu().tolist()
        return {"loss": loss, "grad": first, "change": change}


# --------------------------------------------------------------------------
# One run
# --------------------------------------------------------------------------

def set_up(prog, cell, seed: int, device: torch.device) -> SimpleNamespace:
    """The scan, weights and draws of ``seed``, the program built from
    them, and its first steps with the readings the comparison takes."""
    cfg = cell.cfg
    n_samples = int(cfg["render"]["n_samples"])
    data, proj = cell.reference.make_scan(cfg, seed, device)
    weights = cell.reference.make_weights(cfg, seed, device)
    program = Program(prog, cell, data, weights, seed, device)
    del weights
    pool_counts = (proj.reshape(proj.shape[0], -1) != 0).sum(1)
    del proj
    spe, n_rays, n_batch = program.steps_per_epoch, program.n_rays, program.n_batch
    order = torch.arange(spe * n_batch, device=device).reshape(spe, n_batch)
    gen = reference.generator(seed, reference.DRAWS, device)
    draws = reference.draw_epoch(gen, pool_counts, order, n_rays, n_samples)
    readings = program.first_steps(order, draws, CHECK_STEPS)
    return SimpleNamespace(program=program, readings=readings, order=order, gen=gen,
                           draws=draws, pool_counts=pool_counts)


def reference_inputs(cell, seed: int, device: torch.device, s) -> tuple:
    """The reference's inputs, made again from ``seed``: the projections,
    the initial weights and the first epoch's draws."""
    cfg = cell.cfg
    _, proj = cell.reference.make_scan(cfg, seed, device)
    weights = cell.reference.make_weights(cfg, seed, device)
    draws = reference.draw_epoch(reference.generator(seed, reference.DRAWS, device),
                                 s.pool_counts, s.order, int(cell.traffic["n_rays"]),
                                 int(cfg["render"]["n_samples"]))
    return proj, weights, draws


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: torch.device) -> Tuple[Dict, Dict[str, float]]:
    """Set-up, the window (or the traced block) and the comparison of one
    run of ``cell``; returns the result line's object and the seconds of
    set-up, window and reference."""
    prog = import_program()
    cfg = cell.cfg
    n_samples = int(cfg["render"]["n_samples"])
    s = set_up(prog, cell, seed, device)
    program, order, gen, draws, pool_counts = s.program, s.order, s.gen, s.draws, s.pool_counts
    spe, n_rays, n_batch = program.steps_per_epoch, program.n_rays, program.n_batch
    program.epoch(order, CHECK_STEPS, draws, CHECK_STEPS, spe)
    # The next epoch's draws, refilled in place as the window refills them,
    # so that their buffers are allocated before it starts.
    reference.draw_epoch(gen, pool_counts, order, n_rays, n_samples, out=draws)
    sync(device)
    phases = {"setup_s": time.perf_counter() - _T_START}
    t_window = time.perf_counter()

    losses: List[torch.Tensor] = []
    if not trace:
        timer = StepTimer(device)
        t0 = time.perf_counter()
        setup_s = t0 - _T_START
        timer.tick()
        start = spe
        epochs = 0
        while True:
            losses.append(program.epoch(order, start, draws, 0, spe, timer))
            start += spe
            epochs += 1
            if time.perf_counter() - t0 >= seconds:
                break
            reference.draw_epoch(gen, pool_counts, order, n_rays, n_samples, out=draws)
        sync(device)
        window_s = time.perf_counter() - t0
        # The steps are the harness's own count; the program's marks time them.
        steps = epochs * spe
        step_ms = timer.step_ms()
        if len(step_ms) != steps:
            raise MeasurementError(f"the program marked {len(step_ms)} step boundaries "
                                   f"in {steps} steps")
        stats = {"rays_per_s": steps * n_rays * n_batch / window_s,
                 "step_ms_p95": float(np.percentile(step_ms, 95)), "setup_s": setup_s}
    else:
        # Every traced epoch's draws are made before the trace starts, so
        # that the traced block holds the program's work alone.
        fed = [draws] + [reference.draw_epoch(gen, pool_counts, order, n_rays, n_samples)
                         for _ in range(TRACE_EPOCHS - 1)]
        sync(device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            start = spe
            for d in fed:
                with torch.profiler.record_function("portbench.epoch"):
                    losses.append(program.epoch(order, start, d, 0, spe))
                start += spe
            sync(device)
        steps = TRACE_EPOCHS * spe
        tr = trace_reader.Trace(prof, steps)
        del prof, fed, d
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    all_losses = torch.cat(losses).cpu()
    failed = int((~torch.isfinite(all_losses)).sum())
    phases["window_s"] = time.perf_counter() - t_window
    t_ref = time.perf_counter()
    del program, draws, losses, s.program, s.draws
    free(device)

    # The reference follows the first steps, from the same inputs.
    proj, weights, draws = reference_inputs(cell, seed, device, s)
    seen = {}

    def points(i, x01):
        if trace:
            seen[i] = counts.distinct_rows(cell.reference.corner_rows(cfg, x01))

    ref = cell.reference.reference_readings(cfg, proj, weights, draws, order,
                                            steps=CHECK_STEPS, steps_per_epoch=spe,
                                            points=points)
    gaps = reference.compare(s.readings, ref)
    phases["reference_s"] = time.perf_counter() - t_ref
    correct = failed == 0 and all(gaps[k] <= float(cell.limits[k]) for k in gaps)

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu"),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    metrics = {}
    if not trace:
        stats["peak_mem_mb"] = peak / 1e6
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": stats[m["name"]], "unit": m["unit"]}
    else:
        ctx = {"trace": tr, "work": work_of(cell, seen)}
        for m in cell.per_layer:
            v = trace_reader.load_reader(cell.metrics_dir, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
    result = {"correct": bool(correct), "attempted": int(steps),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = tr.breakdown()
    # The numbers compared, each beside its limit, come last.
    result["checks"] = {k: {"value": gaps[k], "limit": float(cell.limits[k])}
                        for k in gaps}
    return result, phases


def work_of(cell, seen: Dict) -> Dict:
    """The counts the per-layer readers divide by: the step's operations
    (``train_step``) and the encoder's bytes and operations
    (``hash_encoder``), from the widths and the points of the compared
    steps."""
    cfg, enc = cell.cfg, cell.cfg["encoder"]
    dims = cell.reference.layer_dims(cfg)
    levels, channels = int(enc["num_levels"]), int(enc["level_dim"])
    rows = 1 << int(enc["log2_hashmap_size"])
    points = (int(cell.traffic["n_rays"]) * int(cell.traffic["n_batch"])
              * int(cfg["render"]["n_samples"]))
    n_params = levels * rows * channels + sum(i * o + o for i, o in dims)
    work = {"train_step": counts.step_flop(points, dims, levels, channels, n_params)}
    if seen:
        distinct = float(np.mean(list(seen.values())))
        work["hash_encoder"] = counts.hash_encoder_work(points, levels, rows,
                                                        channels, distinct)
    return work


def finish(result: Dict, phases: Dict[str, float]) -> int:
    """Print the run's phases, its checks and, where no module of JAX or of
    the JAX package has been loaded, the result line; the exit code."""
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    print("portbench: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload)
        import_program()
    except (KeyError, OSError, ImportError, ValueError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              f"available", file=sys.stderr)
        return 2
    try:
        result, phases = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                  torch.device("cuda", 0))
    except MeasurementError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    return finish(result, phases)


if __name__ == "__main__":
    sys.exit(main())
