#!/usr/bin/env python3
"""Where the time of the bucket backward kernel goes, level by level, on the card.

Builds the two sorted update streams that ``chip_smoke.py`` holds the
bucket kernel to (``configs/chest_phantom_r3.yaml``, seed 0: one batch of
1024 rays x 192 samples; the main path's 16 x 196,608 base keys with
their fracs at D=3, and the XOR path's 16 x 1,572,864 corner keys at
D=0), then prints for each stream:

- per level: its distinct columns, its longest run (updates of one
  column), its longest tile segment (updates of one 1024-column tile),
  and the kernel's time on that level alone (a one-level call);
- the kernel's time on the whole stream, on an empty stream of the same
  shape (every column zero: the cost of the stores and the per-tile
  searches alone), and the bytes bound (3.35 TB/s).

Times are medians of 20 event-timed calls (``utils/profiling.py::time_fn``).
Run from the repository root on a machine with a CUDA card:

    python3 scripts/bucket_levels_torch.py [--stream main|xor|both]

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
TILE = 1024


def streams(cfg_path: str, dev: torch.device):
    """The main path's and the XOR path's sorted streams of one batch."""
    from neuralvolumetricreconstructionformedicalimages_torch.config import load_config
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        gather_view_batch, load_dataset)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg
    from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
        base_and_frac_t)
    from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (
        hash_grid_indices, sorted_corner_stream)
    from neuralvolumetricreconstructionformedicalimages_torch.ops.roll_kernels import _PAD
    from neuralvolumetricreconstructionformedicalimages_torch.ops.sampling import (
        stratified_z_vals)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        build_model)

    cfg = load_config(cfg_path)
    gen = torch.Generator(device=dev).manual_seed(0)
    field = build_model(cfg, gen, dev)
    spec = field.encoder.grid
    n_rays, n_samples = int(cfg["train"]["n_rays"]), int(cfg["render"]["n_samples"])
    dset = load_dataset(cfg["exp"]["datadir"], "train", n_rays, device=dev)
    rays = gather_view_batch(dset.arrays(), 0, n_rays, gen)["rays"]
    z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], n_samples, True, gen)
    b = field.bound - 1e-6
    pts = torch.clamp(rays[:, None, :3] + rays[:, None, 3:6] * z[..., None], -b, b)
    x01 = torch.clamp((pts.reshape(-1, 3) + field.bound) / (2.0 * field.bound), 0, 1)
    L, S, C = spec.num_levels, spec.table_size, spec.level_dim
    table = torch.randn((L, S, C), generator=gen, device=dev)   # same draws as chip_smoke
    grads = torch.randn((L, C, x01.shape[0]), generator=gen, device=dev)
    del table
    base_t, frac_t = base_and_frac_t(spec, x01)
    sk, perm = torch.sort(base_t, dim=-1, stable=True)
    spf = torch.gather(sg.pack_frac_t(frac_t), 1, perm)[:, None, :].contiguous()
    sf = sg.unpack_frac_t(spf[:, 0])
    xidx, xw = hash_grid_indices(spec, x01)
    xsk, xsg = sorted_corner_stream(xidx, xw, grads.permute(2, 0, 1), S)
    xsf = torch.empty((L, 0, xsk.shape[1]), device=dev)
    return spec, {"main": (sk, sf, grads, spec.input_dim, _PAD),
                  "xor": (xsk, xsf, xsg, 0, 0)}


def level_stats(keys: torch.Tensor):
    """Distinct columns, longest run and longest tile segment of one level."""
    u, counts = torch.unique_consecutive(keys, return_counts=True)
    tiles = torch.bincount((keys.long() // TILE))
    return int(u.numel()), int(counts.max()), int(tiles.max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stream", choices=("main", "xor", "both"), default="both")
    ap.add_argument("--config", default="configs/chest_phantom_r3.yaml")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bucket_levels_torch: no CUDA device available", file=sys.stderr)
        return 1
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import bucket_matmul as bm
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        time_fn)

    dev = torch.device("cuda")
    spec, data = streams(args.config, dev)
    S = spec.table_size
    print(f"card: {torch.cuda.get_device_name(0)}")
    summary = {}
    for name in (("main", "xor") if args.stream == "both" else (args.stream,)):
        keys, frac, grads, D, E = data[name]
        L, B = keys.shape
        C = grads.shape[1]
        F = (1 << D) * C
        kw = dict(table_size=S, input_dim=D, extend_cols=E)

        def ms(k, f, g):
            return time_fn(lambda: bm.bucket_grad_matmul(k, f, g, **kw),
                           warmup=3, iters=20)["median_s"] * 1e3

        total = ms(keys, frac, grads)
        empty = ms(keys[:, :0].contiguous(), frac[:, :, :0].contiguous(),
                   grads[:, :, :0].contiguous())
        bound = (L * B * 4 * (1 + D + C) + L * F * (S + E) * 4) / HBM_BYTES_PER_S * 1e3
        print(f"\n{name}: stream {L} x {B}, D={D}, C={C}, extension {E}")
        print(f"  whole stream {total:.4f} ms, empty stream {empty:.4f} ms, "
              f"bound {bound:.4f} ms")
        print(f"  {'level':>5} {'distinct':>9} {'max run':>8} {'max tile':>9} "
              f"{'ms alone':>9}")
        levels = []
        for l in range(L):
            sl = slice(l, l + 1)
            t = ms(keys[sl].contiguous(), frac[sl].contiguous(), grads[sl].contiguous())
            distinct, run, tile = level_stats(keys[l])
            levels.append(dict(level=l, distinct=distinct, max_run=run,
                               max_tile_segment=tile, ms=t))
            print(f"  {l:5d} {distinct:9d} {run:8d} {tile:9d} {t:9.4f}")
        summary[name] = dict(stream=[L, B], whole_ms=total, empty_ms=empty,
                             bound_ms=bound, levels=levels)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
