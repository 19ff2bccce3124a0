#!/usr/bin/env python3
"""Two-process smoke test of the multi-process bring-up path.

The port of ``scripts/multiprocess_smoke.py`` on ``torch.distributed``:
two processes meet through ``parallel/mesh.py::initialize_multihost`` on
``tcp://localhost:<port>`` (``NVR_SMOKE_PORT``, default 43217), form a
``data=2`` mesh (one rank a process; the JAX script had 2 processes x 4
virtual devices), take two sharded optimizer steps through
``parallel/step.py::make_sharded_train_step`` on the JAX worker's tiny
model and scan, and hash their parameters with SHA-256.  The gradients
are all-reduced over both ranks, so the digests must be identical; any
divergence in the collective layer shows there.

The ranks use gloo, sharing ``cuda:0`` (NCCL refuses two ranks on one
card), or on the CPU with ``--device cpu``.  The scan's
projections are a seeded uniform draw (the JAX worker's came from
``jax.random``).  A rank that has not ended after ``JOIN_S`` is killed;
every collective fails after ``GROUP_TIMEOUT_S``.

    python3 scripts/multiprocess_smoke_torch.py [--device cpu] [--out PATH]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.

Exit 0 and ``MULTIPROCESS SMOKE PASSED`` on success.  Writes
``docs/multiprocess_smoke_torch.md``.  ``run_ranks`` and ``free_port``
start the ranks of ``scripts/shard_overhead_torch.py`` and
``scripts/scaling_sweep_torch.py`` too.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import socket
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = int(os.environ.get("NVR_SMOKE_PORT", "43217"))
N_PROC = 2
GROUP_TIMEOUT_S, JOIN_S = 120.0, 420.0
OUT = "docs/multiprocess_smoke_torch.md"


def free_port() -> int:
    """A TCP port of localhost that no process holds now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, out_dir: str, args: Sequence) -> None:
    res = fn(rank, *args)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              join_s: float = JOIN_S) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes and return
    their results (JSON-able) in rank order.  A rank that raises fails the
    call; ranks still alive after ``join_s`` seconds, or after another
    failed, are killed."""
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="nvr_ranks_")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_rank_main, args=(fn, out_dir, tuple(args)), nprocs=world,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > join_s:
                raise RuntimeError(f"the {world} ranks did not end in {join_s:.0f} s")
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                results.append(json.load(f))
        return results
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
        shutil.rmtree(out_dir, ignore_errors=True)


def join_group(rank: int, world: int, port: int, device: str) -> None:
    """``initialize_multihost`` on ``localhost:port`` under gloo (on
    ``cuda:0`` for a card device), with a finite timeout."""
    sys.path.insert(0, ROOT)
    from neuralvolumetricreconstructionformedicalimages_torch.parallel.mesh import (
        initialize_multihost)
    initialize_multihost(coordinator_address=f"localhost:{port}", num_processes=world,
                         process_id=rank, backend="gloo", device=device,
                         timeout_s=GROUP_TIMEOUT_S)


def worker_cfg() -> Dict[str, Any]:
    """The JAX worker's config (before ``with_defaults``)."""
    return {
        "exp": {"expname": "mp", "expdir": "/tmp", "datadir": ""},
        "network": {"net_type": "mlp", "num_layers": 3, "hidden_dim": 16,
                    "skips": [1], "out_dim": 1, "last_activation": "sigmoid",
                    "bound": 0.3},
        "encoder": {"encoding": "hashgrid", "input_dim": 3, "num_levels": 4,
                    "level_dim": 2, "base_resolution": 4,
                    "log2_hashmap_size": 8},
        "render": {"n_samples": 16, "n_fine": 0, "perturb": True,
                   "raw_noise_std": 0.0},
        "train": {"epoch": 1, "n_batch": 1, "n_rays": 128, "lrate": 1e-3,
                  "lrate_gamma": 0.1, "lrate_step": 100, "resume": False},
        "log": {"i_eval": 0, "i_save": 0},
    }


def worker_arrays(device) -> Dict[str, Any]:
    """The JAX worker's scan: 4 cone-beam views of 8^2 (1 cm pixels) of an
    8^3 volume of 1 cm voxels, rays precomputed, projections a seeded
    uniform draw x 0.1, no mask, every pixel valid."""
    from batch_sweep_torch import scan_arrays
    return scan_arrays(device, 4, (8, 8), n_voxel=8, d_voxel=0.01, d_det=0.01)


def params_sha256(module) -> str:
    """SHA-256 of every parameter's bytes, in order."""
    h = hashlib.sha256()
    for p in module.parameters():
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def worker(rank: int, world: int, port: int, device: str) -> Dict[str, Any]:
    """One rank: join the group, two sharded steps on a ``data=world``
    mesh, and the digest of the updated parameters."""
    import torch
    import torch.distributed as dist

    join_group(rank, world, port, device)
    try:
        from neuralvolumetricreconstructionformedicalimages_torch.config import (
            with_defaults)
        from neuralvolumetricreconstructionformedicalimages_torch.parallel import (
            MeshSpec, make_mesh, make_sharded_train_step)
        from neuralvolumetricreconstructionformedicalimages_torch.train.optim import (
            make_optimizer)
        from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
            build_model, pin_fp32)

        dev = torch.device("cuda", 0) if device.startswith("cuda") else torch.device("cpu")
        pin_fp32()
        if dist.get_world_size() != world:
            raise RuntimeError(f"the group has {dist.get_world_size()} ranks, not {world}")
        print(f"[proc {rank}] world_size={world} backend={dist.get_backend()} "
              f"device={dev}", flush=True)
        cfg = with_defaults(worker_cfg())
        arrays = worker_arrays(dev)
        # the data axis spans every rank, so the all-reduce crosses the
        # process boundary: the path under test
        mesh = make_mesh(MeshSpec(data=world, sample=1), dev.type)
        g = torch.Generator(device=dev).manual_seed(0)
        field = build_model(cfg, g, dev)
        step_fn = make_sharded_train_step(
            cfg, field, make_optimizer(cfg, field.parameters()), mesh,
            steps_per_epoch=4, generator=g, n_rays=cfg["train"]["n_rays"],
            n_batch=1, use_mask=False)
        views = torch.zeros((1,), dtype=torch.long, device=dev)
        for i in range(2):
            loss = step_fn(arrays, views, i)
        digest = params_sha256(field)
        print(f"[proc {rank}] step=2 loss={float(loss):.6f} params_sha256={digest}",
              flush=True)
        return {"rank": rank, "loss": float(loss), "params_sha256": digest,
                "backend": dist.get_backend(), "device": str(dev)}
    finally:
        dist.destroy_process_group()


def smoke(device: str = "cpu", port: int = PORT) -> Dict[str, Any]:
    """The two ranks' results and the verdict (identical digests)."""
    t0 = time.perf_counter()
    ranks = run_ranks(worker, N_PROC, (N_PROC, port, device))
    digests = [r["params_sha256"] for r in ranks]
    return {"ranks": ranks, "ok": len(set(digests)) == 1, "port": port,
            "device": device, "wall_s": time.perf_counter() - t0}


def report(res: Dict[str, Any], card: str) -> str:
    lines = ["# Multi-process smoke (`scripts/multiprocess_smoke_torch.py`)", "",
             f"Device: {res['device']} ({card}). {N_PROC} processes meet through "
             f"`initialize_multihost` on `tcp://localhost`, one rank a process, mesh "
             f"`data={N_PROC}` under {res['ranks'][0]['backend']}; two sharded steps "
             f"of the JAX worker's tiny model; {res['wall_s']:.1f} s with the "
             f"processes' start.", "",
             "| rank | device | loss after step 2 | params SHA-256 |", "|---|---|---|---|"]
    lines += [f"| {r['rank']} | {r['device']} | {r['loss']:.6f} | `{r['params_sha256']}` |"
              for r in res["ranks"]]
    lines += ["", "MULTIPROCESS SMOKE " + ("PASSED: identical parameters on every rank."
                                          if res["ok"] else "FAILED: the digests differ.")]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="where the gloo ranks run: sharing cuda:0 (default), or "
                        "the CPU")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from real_scale_train_r5_torch import card_line

    if args.device == "cuda":
        from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
            resolve_device)
        resolve_device("cuda")
    res = smoke(args.device)
    for r in res["ranks"]:
        print(f"[proc {r['rank']}] loss={r['loss']:.6f} params_sha256={r['params_sha256']}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(report(res, card_line(args.device)))
    if res["ok"]:
        print(f"MULTIPROCESS SMOKE PASSED: {N_PROC} processes, identical params "
              f"{res['ranks'][0]['params_sha256'][:16]}...")
        return 0
    print("MULTIPROCESS SMOKE FAILED")
    return 1


if __name__ == "__main__":
    sys.exit(main())
