#!/usr/bin/env python3
"""Verify drive: fit the field to analytic ball-phantom projections on the card.

The port of ``scripts/verify_drive.py``, the JAX package's end-to-end
acceptance test, on a second model shape: geometry, ray generation, the
hash encoder (8 levels x 2^15 f32 table: the span gather's table mode
forward, the bucket and the unroll backward), the MLP with its ``relu``
head (LeakyReLU 0.01), the renderer, Beer-Lambert integration, autograd,
Adam and the eval query.

- 16 parallel-beam views of 24^2 rays through a uniform ball of radius
  0.1; a ray's target is its chord ``2 sqrt(r^2 - b^2)``.
- A step draws 1024 of the 9,216 rays without replacement (the first 1024
  of a random permutation: an argsort of uniform draws, made on the card
  for a block of steps at once), renders them at 96 jittered samples and
  takes one Adam step on the MSE.
- The rate is optax's ``piecewise_constant_schedule(1e-2, {1500: 0.1,
  2500: 0.3})``, whose scales multiply: 1e-2, 1e-3 from update 1500, 3e-4
  from update 2500.  It is set between blocks of 100 steps; the boundaries
  fall on block edges, so every update reads its own rate.
- The steps run as one captured CUDA graph replayed step by step
  (``train/trainer.py::_GraphedStep``, capturable Adam).  The wall-clock
  deadline is checked between blocks, never inside one.
- Eval: projection PSNR over all rays, then the field on a 48^3 grid: the
  mean density inside 0.8 r and the mean |density| outside 1.2 r.

Prints ``VERIFY PASS`` (exit 0) only at proj PSNR > 50 dB, inside > 0.8
and outside < 0.1, the JAX script's thresholds; else ``VERIFY FAIL`` (exit
1).  Writes ``docs/verify_drive_torch.md``.

    python3 scripts/verify_drive_torch.py [DEADLINE_S] [--device cpu] [--out PATH]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_torch import geometry as G  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.models import (  # noqa: E402
    get_encoder, get_network)
from neuralvolumetricreconstructionformedicalimages_torch.render import (  # noqa: E402
    query_field, render_image, render_rays)
from neuralvolumetricreconstructionformedicalimages_torch.train.optim import (  # noqa: E402
    make_optimizer, set_lr)
from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (  # noqa: E402
    _GraphedStep, pin_fp32, resolve_device)

OUT = "docs/verify_drive_torch.md"
DEADLINE_S = 420.0
GEOMETRY = dict(DSD=1.5, DSO=1.0, nDetector=(24, 24), dDetector=(0.025, 0.025),
                nVoxel=(64, 64, 64), dVoxel=(0.004, 0.004, 0.004), mode="parallel")
N_ANGLES = 16
RADIUS = 0.1
ENCODER = dict(num_levels=8, log2_hashmap_size=15, backward="bucket")
NETWORK = dict(num_layers=4, hidden_dim=32, skips=(2,), out_dim=1,
               last_activation="relu", bound=0.15)
N_RAYS, N_SAMPLES = 1024, 96
BLOCKS, BLOCK_STEPS = 35, 100
LR0, LR_SCALES = 1e-2, {1500: 0.1, 2500: 0.3}
GRID, GRID_EXTENT, QUERY_TILE = 48, 0.12, 36864
PSNR_MIN, INSIDE_MIN, OUTSIDE_MAX = 50.0, 0.8, 0.1


def lr_at(update: int) -> float:
    """optax's ``piecewise_constant_schedule(LR0, LR_SCALES)`` at
    ``update`` (the updates already done): every scale whose boundary is
    at or below it multiplies."""
    lr = LR0
    for boundary, scale in sorted(LR_SCALES.items()):
        if update >= boundary:
            lr *= scale
    return lr


def scan(device="cpu"):
    """The 16 views' rays [9216, 8] and each ray's chord through the ball
    [9216]."""
    geo = G.ConeGeometry(**GEOMETRY)
    near, far = G.get_near_far(geo)
    angles = np.linspace(0, np.pi, N_ANGLES, endpoint=False).astype(np.float32)
    ro, rd = G.rays_for_angles(geo, angles, device)
    rays = G.pack_rays(ro, rd, near, far).reshape(-1, 8)
    o3, d3 = rays[:, :3], rays[:, 3:6]
    d3n = d3 / torch.linalg.vector_norm(d3, dim=-1, keepdim=True)
    b = torch.linalg.vector_norm(torch.linalg.cross(o3, d3n, dim=-1), dim=-1)
    gt = 2.0 * torch.sqrt(torch.clamp(RADIUS * RADIUS - b * b, min=0.0))
    return rays, gt


def build(device="cpu", generator: Optional[torch.Generator] = None):
    """The field (8 x 2^15 hash grid, 4 x 32 MLP, ``relu`` head, bound
    0.15) and its Adam at the first rate."""
    enc = get_encoder("hashgrid", **ENCODER)
    field = get_network("mlp")(encoder=enc, generator=generator, device=device,
                               **NETWORK)
    return field, make_optimizer({"train": {"lrate": LR0}}, field.parameters())


def make_step(field, optimizer, generator: Optional[torch.Generator]):
    """``step(arrays, idx, *, t_rand=None) -> loss``: the rays ``idx``
    [N_RAYS] of ``arrays["rays"]`` rendered at ``N_SAMPLES`` jittered
    samples (``t_rand`` fed, else drawn from ``generator``), the MSE to
    ``arrays["gt"]`` and one Adam step at the optimizer's rate; no host
    sync, so it can be captured."""
    def step(arrays, idx, *, t_rand=None):
        optimizer.zero_grad(set_to_none=True)
        out = render_rays(arrays["rays"][idx], field, n_samples=N_SAMPLES,
                          perturb=True, generator=generator, t_rand=t_rand)
        loss = torch.mean((out["acc"] - arrays["gt"][idx]) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def draw_indices(generator: torch.Generator, n: int, steps: int,
                 device) -> torch.Tensor:
    """[steps, N_RAYS] int64: each row ``N_RAYS`` of ``n`` indices without
    replacement, the first of an argsort of uniform draws (a random
    permutation), drawn on ``device``."""
    u = torch.rand((steps, n), generator=generator, device=device)
    return torch.argsort(u, dim=1)[:, :N_RAYS]


class Drive:
    """The drive's state: scan, field, Adam, generator and the graphed
    step; :meth:`block` runs one block of steps, :meth:`train` the rest
    of the 35, :meth:`evaluate` the eval."""

    def __init__(self, device=None, seed: int = 0):
        self.device = resolve_device(device)
        pin_fp32()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        rays, gt = scan(self.device)
        self.arrays = {"rays": rays, "gt": gt}
        self.field, self.optimizer = build(self.device, self.generator)
        self.step = make_step(self.field, self.optimizer, self.generator)
        # the graph's input buffer is its "views": here the step's ray indices
        self.graphed = _GraphedStep(self.step, self.optimizer, self.generator)
        self.steps_done = 0
        self.blocks: List[Dict[str, float]] = []

    def block(self) -> torch.Tensor:
        """``BLOCK_STEPS`` steps at the rate of the block's first update
        (eager on the CPU; on the card the first call captures the graph
        and every further step replays it); the losses, read back (the
        block's fence)."""
        t0 = time.perf_counter()
        set_lr(self.optimizer, lr_at(self.steps_done))
        idx = draw_indices(self.generator, self.arrays["rays"].shape[0], BLOCK_STEPS,
                           self.device)
        losses = torch.empty(BLOCK_STEPS, device=self.device)
        for i in range(BLOCK_STEPS):
            if self.device.type == "cuda":
                losses[i] = self.graphed(self.arrays, {"views": idx[i]})
            else:
                losses[i] = self.step(self.arrays, idx[i])
        losses = losses.cpu()
        self.steps_done += BLOCK_STEPS
        self.blocks.append({"steps": self.steps_done, "loss": float(losses[-1]),
                            "lr": lr_at(self.steps_done - BLOCK_STEPS),
                            "wall_s": time.perf_counter() - t0})
        return losses

    def train(self, deadline: Optional[float] = None, log=print) -> None:
        """The blocks left of ``BLOCKS``; stops between blocks once the
        ``time.time()`` ``deadline`` has passed."""
        while len(self.blocks) < BLOCKS:
            if deadline is not None and time.time() > deadline:
                log("deadline reached between dispatches — stopping")
                break
            self.block()
            b = self.blocks[-1]
            log(f"steps {b['steps']}: loss {b['loss']:.3e} ({b['wall_s']:.1f}s)")

    def ms_per_step(self) -> float:
        """Median host ms a step over the blocks after the first (which
        holds the eager step and the capture)."""
        walls = [b["wall_s"] for b in self.blocks[1:]] or [self.blocks[0]["wall_s"]]
        return float(np.median(walls)) / BLOCK_STEPS * 1e3

    def evaluate(self) -> Dict[str, Any]:
        """Projection PSNR over every ray, the field's means inside and
        outside the ball on the 48^3 grid, and the verdict."""
        rays, gt = self.arrays["rays"], self.arrays["gt"]
        acc = render_image(rays, self.field, n_samples=N_SAMPLES, tile=rays.shape[0])
        mse = float(torch.mean((acc - gt) ** 2))
        psnr = -10.0 * np.log10(mse / float(torch.max(gt) ** 2))
        ax = np.linspace(-GRID_EXTENT, GRID_EXTENT, GRID, dtype=np.float32)
        gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
        pts = torch.as_tensor(np.stack([gx, gy, gz], -1).reshape(-1, 3), device=self.device)
        f = query_field(pts, self.field, tile=QUERY_TILE)[:, 0].cpu().numpy()
        rad = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2).reshape(-1)
        m_in = float(f[rad < 0.8 * RADIUS].mean())
        m_out = float(np.abs(f[rad > 1.2 * RADIUS]).mean())
        ok = psnr > PSNR_MIN and m_in > INSIDE_MIN and m_out < OUTSIDE_MAX
        return {"proj_psnr": float(psnr), "proj_mse": mse, "inside": m_in,
                "outside": m_out, "ok": bool(ok)}


def report(rec: Dict[str, Any], card: str) -> str:
    """The Markdown of one drive's record."""
    lines = [
        "# Verify drive on the card (`scripts/verify_drive_torch.py`)", "",
        f"Card: {card}.", "",
        "Second model shape: 8 levels x 2^15 f32 hash table, 4 x 32 MLP with a "
        "`relu` head, bound 0.15; 16 parallel-beam views of 24^2 through a ball of "
        "radius 0.1; 1024 of the 9,216 rays a step without replacement, 96 "
        "jittered samples; Adam at 1e-2 / 1e-3 from update 1500 / 3e-4 from 2500; "
        f"{BLOCKS} blocks of {BLOCK_STEPS} graphed steps.", "",
        f"- steps: {rec['steps']} ({rec['ms_per_step']:.3f} ms a step, median of the "
        f"blocks after the first; first block, with the capture, "
        f"{rec['first_block_s']:.2f} s)",
        f"- proj PSNR: {rec['proj_psnr']:.2f} dB (pass > {PSNR_MIN:g})",
        f"- mean density inside 0.8 r: {rec['inside']:.4f} (pass > {INSIDE_MIN:g})",
        f"- mean |density| outside 1.2 r: {rec['outside']:.4f} (pass < {OUTSIDE_MAX:g})",
        f"- eval: {rec['eval_s']:.2f} s",
        f"- verdict: VERIFY {'PASS' if rec['ok'] else 'FAIL'}", "",
        "| steps | rate | last loss | block s |", "|---|---|---|---|"]
    lines += [f"| {b['steps']} | {b['lr']:.0e} | {b['loss']:.3e} | {b['wall_s']:.2f} |"
              for b in rec["blocks"]]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("deadline", nargs="?", type=float, default=DEADLINE_S,
                   help="wall-clock seconds after which no new block starts")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    os.chdir(ROOT)
    from real_scale_train_r5_torch import card_line

    t_end = time.time() + args.deadline
    drive = Drive(args.device)
    card = card_line(drive.device)
    print(f"device: {drive.device} ({card})", flush=True)
    drive.train(deadline=t_end, log=lambda m: print(m, flush=True))
    t0 = time.perf_counter()
    rec = drive.evaluate()
    rec.update(eval_s=time.perf_counter() - t0, steps=drive.steps_done,
               ms_per_step=drive.ms_per_step(), first_block_s=drive.blocks[0]["wall_s"],
               blocks=drive.blocks, card=card)
    print(f"proj PSNR: {rec['proj_psnr']:.1f} dB  mean sigma inside={rec['inside']:.3f} "
          f"outside={rec['outside']:.3f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(report(rec, card))
    print("VERIFY", "PASS" if rec["ok"] else "FAIL", flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
