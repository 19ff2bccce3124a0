"""The plain reference of NAF as published: the training step of
``reference.py`` with the hash grid of torch-ngp's ``hashencoder``, which
NAF (github.com/Ruyi-Zha/naf_cbct, ``src/encoder``) encodes with.

Imports nothing of the program, of the JAX package or of JAX.  The scan,
the weights, the layer widths, the loss, the MLP, Adam and the judging are
``reference.py``'s; only the corner rows of a point differ.  The grid,
written from torch-ngp's kernel (``get_grid_index``, ``fast_hash``):

- level l has scale ``2^l * base_resolution - 1`` and resolution
  ``ceil(scale) + 1``; a point ``x`` in [0, 1]^3 sits at ``pos = x * scale
  + 0.5``, its cell at ``floor(pos)``, its 8 corners at ``floor(pos) +
  bit`` (bit d of the corner's number along axis d), its trilinear weights
  the products over the axes of ``frac`` or ``1 - frac``;
- a level whose ``(res + 1)^3`` corners fit the table's 2^T rows is dense:
  row ``x + y (res + 1) + z (res + 1)^2``;
- every other level hashes: row ``(x * 1) ^ (y * 19349663) ^ (z *
  83492791)``, products and XOR in uint32, then mod 2^T.

Departures, none of which changes a number:

- the products are taken in int64; the low 32 bits of an int64 product
  are those of the uint32 product, XOR acts bit by bit, and mod 2^T keeps
  the low T bits, so the rows are torch-ngp's;
- torch-ngp packs the levels back to back, a dense level taking only its
  ``(res + 1)^3`` rows; here, as in the program, every level takes 2^T
  rows and level l starts at row ``l * 2^T``;
- the table's gradient is summed with ``index_add_``, as in
  ``reference.py``; torch-ngp adds with ``atomicAdd``: the same sums in
  another order.

It covers NAF's configuration as published: the XOR hash, the table
gathered in f32, positions in f32 (no packing); it refuses any other.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import reference
from reference import layer_dims, make_scan, make_weights  # noqa: F401

# torch-ngp's fast_hash primes of the first three axes.
PRIMES = (1, 19349663, 83492791)


class XorHashGrid:
    """torch-ngp's grid of ``cfg["encoder"]``, with what ``reference._Encode``
    reads of a grid: ``corners``, ``C``, ``bf16_table`` and ``quantized``."""

    bf16_table = False
    quantized = False

    def __init__(self, enc: Dict):
        check(enc)
        self.L = int(enc["num_levels"])
        self.C = int(enc["level_dim"])
        self.S = 1 << int(enc["log2_hashmap_size"])
        levels = np.arange(self.L, dtype=np.float64)
        self.scales = (np.exp2(levels) * int(enc["base_resolution"]) - 1.0).astype(np.float32)
        res = np.ceil(self.scales.astype(np.float64)).astype(np.int64) + 1
        self.dense = (res + 1) ** 3 <= self.S
        self.strides = np.stack([(res + 1) ** d for d in range(3)], -1)     # [L, 3]

    def rows(self, corner: torch.Tensor) -> torch.Tensor:
        """Flat table rows [..., L, K] of integer corners [..., L, K, 3]."""
        dev = corner.device
        strides = torch.as_tensor(self.strides, device=dev)[:, None, :]   # [L, 1, 3]
        dense = (corner * strides).sum(-1)
        # int64 products: their low 32 bits are torch-ngp's uint32 products,
        # and mod 2^T keeps only low bits
        hashed = ((corner[..., 0] * PRIMES[0]) ^ (corner[..., 1] * PRIMES[1])
                  ^ (corner[..., 2] * PRIMES[2]))
        is_dense = torch.as_tensor(self.dense, device=dev)[:, None]       # [L, 1]
        rows = torch.where(is_dense, dense, hashed) % self.S
        return rows + torch.arange(self.L, device=dev)[:, None] * self.S

    def corners(self, x01: torch.Tensor):
        """Flat table rows [P, L, 8] and trilinear weights [P, L, 8] f32 of
        points ``x01`` [P, 3] in [0, 1]."""
        dev = x01.device
        scales = torch.as_tensor(self.scales, device=dev)
        pos = x01[:, None, :] * scales[None, :, None] + 0.5           # [P, L, 3]
        grid = torch.floor(pos)
        frac = pos - grid
        bits = torch.tensor([[(k >> d) & 1 for d in range(3)] for k in range(8)],
                            device=dev)                              # [8, 3]
        corner = grid.to(torch.int64)[:, :, None, :] + bits          # [P, L, 8, 3]
        w = []
        for k in range(8):
            t = [frac[..., d] if (k >> d) & 1 else 1.0 - frac[..., d] for d in range(3)]
            w.append(t[0] * t[1] * t[2])
        return self.rows(corner), torch.stack(w, -1)


def check(enc: Dict) -> None:
    """Refuse an encoder that this reference does not follow."""
    if enc.get("hash_variant") != "xor" or int(enc["input_dim"]) != 3:
        raise ValueError("this reference covers the XOR hash in 3-D")
    if enc.get("table_dtype", "float32") != "float32":
        raise ValueError("this reference gathers the table in f32 (table_dtype float32)")
    if enc.get("pack_sort", False):
        raise ValueError("this reference keeps positions in f32 (pack_sort false)")


def corner_rows(cfg: Dict, x01: torch.Tensor) -> torch.Tensor:
    """Flat table rows [P, L, 8] of the corners of points ``x01`` [P, 3] in
    [0, 1], for the count of distinct rows a step touches."""
    return XorHashGrid(cfg["encoder"]).corners(x01)[0]


class XorReference(reference.Reference):
    """``reference.Reference`` with torch-ngp's grid in place of the
    coherent one, which its set-up builds and which refuses the XOR hash."""

    def __init__(self, cfg: Dict, *args, **kw):
        grid = XorHashGrid(cfg["encoder"])
        coherent = dict(cfg, encoder=dict(cfg["encoder"], hash_variant="coherent"))
        super().__init__(coherent, *args, **kw)
        self.cfg = cfg
        self.grid = grid


def reference_readings(cfg: Dict, proj: torch.Tensor, weights: Dict[str, torch.Tensor],
                       draws: Dict[str, torch.Tensor], views: torch.Tensor, *,
                       steps: int, steps_per_epoch: int, tf32: bool = False,
                       keep: float = 1.0, points=None) -> Dict:
    """``reference.reference_readings`` with :class:`XorReference`: each
    step's loss, each leaf's first gradient's norm and each leaf's change
    after the last step."""
    ref = XorReference(cfg, proj, weights, steps_per_epoch=steps_per_epoch,
                       tf32=tf32, keep=keep)
    before = {k: v.detach().cpu().numpy().copy() for k, v in ref.params.items()}
    losses, first = [], None
    for i in range(steps):
        loss, grads = ref.step(views[i], draws["r"][i], draws["t_rand"][i])
        losses.append(loss)
        if first is None:
            first = reference.norms(grads)
        if points is not None:
            points(i, ref.last_points)
        del grads
    return {"loss": losses, "grad": first,
            "change": reference.change_norms(ref.params, before)}
