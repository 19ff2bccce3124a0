"""Multiresolution hash-grid encoding (Instant-NGP style), XOR variant.

Port of the JAX ``ops/hash_encoding.py``:

- :class:`HashGridSpec`: per-level scale ``2^l * H - 1``, resolution
  ``ceil(scale) + 1``, per-level live size ``min(2^S, (res+1)^D)`` and the
  uniformly padded ``[L, 2^S, C]`` table initialised U(-1e-4, 1e-4);
- :func:`hash_grid_indices`: corner indices, dense row-major while
  ``(res+1)^D`` fits the table, else the reference's XOR-prime hash;
- :func:`hash_encode`: the plain gather + weighted sum (autograd's scatter
  is its backward);
- :func:`hash_encode_fast`: the same forward, with the table gradient from
  a stable sort of the corner-expanded update stream and the bucket kernel
  at ``input_dim=0`` (deterministic, no atomics), and analytic position
  gradients.

Integer exactness: JAX multiplies and XORs in int32 with wraparound.  Here
the products are taken in int64 (primes and strides as their uint32
values), whose low 32 bits are JAX's bits; the result is masked to
``S - 1``, so the indices are the same bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

# XOR-prime multipliers for up to 3 input dims (the reference hash).
_HASH_PRIMES = (1, 19349663, 83492791)


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static hash-grid configuration (hashable)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def table_size(self) -> int:
        """Padded per-level table length (power of two)."""
        return 1 << self.log2_hashmap_size

    @functools.cached_property
    def scales(self) -> np.ndarray:
        """Per-level scale ``2^l * H - 1`` (float32, [L])."""
        levels = np.arange(self.num_levels, dtype=np.float64)
        return (np.exp2(levels) * self.base_resolution - 1.0).astype(np.float32)

    @functools.cached_property
    def resolutions(self) -> np.ndarray:
        """Per-level grid resolution ``ceil(scale) + 1`` (int64, [L])."""
        return (np.ceil(self.scales.astype(np.float64)) + 1).astype(np.int64)

    @functools.cached_property
    def level_sizes(self) -> np.ndarray:
        """Actual entries per level: ``min(2^S, (res+1)^D)`` (int64, [L])."""
        dense = (self.resolutions + 1) ** self.input_dim
        return np.minimum(dense, self.table_size).astype(np.int64)

    @functools.cached_property
    def dense_levels(self) -> np.ndarray:
        """Bool [L]: level uses the dense row-major layout (no hashing)."""
        return ((self.resolutions + 1) ** self.input_dim) <= self.table_size

    @property
    def n_params(self) -> int:
        """Live (non-padding) parameter count."""
        return int(self.level_sizes.sum()) * self.level_dim

    def init(self, generator: Optional[torch.Generator] = None,
             device="cpu", dtype=torch.float32) -> torch.Tensor:
        """Table init U(-1e-4, 1e-4), shape ``[L, 2^S, C]``."""
        shape = (self.num_levels, self.table_size, self.level_dim)
        u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
        return u * 2e-4 - 1e-4


def hash_grid_indices(spec: HashGridSpec, x01: torch.Tensor):
    """Corner indices + interpolation weights for points ``x01`` in [0, 1].

    Returns:
      idx: int32 [B, L, 2^D] per-level table indices (pre-offset)
      w:   float32 [B, L, 2^D] trilinear weights
    """
    idx, w, _ = _indices_weights_frac(spec, x01)
    return idx, w


def _indices_weights_frac(spec: HashGridSpec, x01: torch.Tensor):
    """:func:`hash_grid_indices` plus ``frac`` [B, L, D], which the analytic
    input gradients need."""
    from .coherent_hash import corner_bits

    D = spec.input_dim
    S = spec.table_size
    dev = x01.device
    scales = torch.as_tensor(spec.scales, device=dev)              # [L]
    pos = x01[:, None, :].to(torch.float32) * scales[None, :, None]
    pos = pos + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid                                          # [B, L, D]

    bits = torch.as_tensor(corner_bits(D), device=dev)             # [K, D]
    corner = pos_grid.to(torch.int64)[:, :, None, :] + bits[None, None]

    # Interp weight: prod_d (bit ? frac : 1 - frac).
    w = torch.prod(torch.where(bits[None, None] > 0, frac[:, :, None, :],
                               1.0 - frac[:, :, None, :]), dim=-1)  # [B, L, K]

    # Dense row-major index, stride (res+1)^d per dim, the strides wrapped
    # mod 2^32 like the reference's uint32 math (a wrapped stride only
    # occurs on hashed levels, where the dense branch is discarded).  Dense
    # levels are in range by construction ((res+1)^D <= S).
    res_p1 = (spec.resolutions + 1).astype(np.uint64)
    strides = np.stack([res_p1 ** d for d in range(D)], -1) & 0xFFFFFFFF
    strides = torch.as_tensor(strides.astype(np.int64), device=dev)  # [L, D]
    idx_dense = torch.sum(corner * strides[None, :, None, :], dim=-1)

    # XOR-prime hash; hashed levels have exactly 2^S entries -> mask.
    primes = _HASH_PRIMES[:D]
    idx_hash = corner[..., 0] * primes[0]
    for d in range(1, D):
        idx_hash = idx_hash ^ (corner[..., d] * primes[d])

    dense = torch.as_tensor(spec.dense_levels, device=dev)          # [L] bool
    idx = torch.where(dense[None, :, None], idx_dense, idx_hash) & (S - 1)
    return idx.to(torch.int32), w, frac


def _he_forward(x01: torch.Tensor, table: torch.Tensor, spec: HashGridSpec):
    """One gather over the padded table and the weighted corner sum:
    features [B, L*C] and (idx, w, frac, vals [B, L, K, C])."""
    B = x01.shape[0]
    L, S, C = table.shape
    idx, w, frac = _indices_weights_frac(spec, x01)                # [B, L, K]
    level_off = torch.arange(L, device=idx.device)[None, :, None] * S
    vals = table.reshape(L * S, C)[idx.long() + level_off]         # [B, L, K, C]
    out = torch.sum(w[..., None].to(vals.dtype) * vals, dim=2)     # [B, L, C]
    return out.reshape(B, L * C), (idx, w, frac, vals)


def hash_encode(x01: torch.Tensor, table: torch.Tensor,
                spec: HashGridSpec) -> torch.Tensor:
    """Encode points ``x01`` in [0, 1]^D -> features [B, L*C].

    Plain path: one gather over the padded table and a weighted sum;
    autograd's scatter-add is the backward (atomic on the card, so its
    table gradient is not bitwise reproducible there).
    """
    return _he_forward(x01, table, spec)[0]


def sorted_corner_stream(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """The XOR backward's update stream, sorted per level.

    Element (b, l, k) has key ``idx[b, l, k]`` and payload lane c =
    ``w[b, l, k] * g[b, l, c]``.  Returns the keys [L, B*K] int32 sorted
    stably (ties keep stream order) and the payload [L, C, B*K] f32 in
    that order, both contiguous.
    """
    B, L, K = idx.shape
    C = g.shape[-1]
    N = B * K
    keys = idx.permute(1, 0, 2).reshape(L, N)
    sk, perm = torch.sort(keys, dim=-1, stable=True)
    pay = (w[..., None] * g[:, :, None, :]).permute(1, 3, 0, 2).reshape(L, C, N)
    sg = torch.gather(pay, 2, perm[:, None, :].expand(L, C, N))
    return sk.contiguous(), sg


class _HashEncodeFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x01, table, spec):
        out, res = _he_forward(x01, table, spec)
        ctx.save_for_backward(*res)
        ctx.spec = spec
        ctx.table_shape = tuple(table.shape)
        return out

    @staticmethod
    def backward(ctx, g):
        from .bucket_matmul import bucket_grad_matmul
        from .coherent_hash import corner_weight_grads

        idx, w, frac, vals = ctx.saved_tensors
        spec = ctx.spec
        L, S, C = ctx.table_shape
        B, _, K = idx.shape
        g = g.reshape(B, L, C).to(torch.float32)

        # Table gradient: the corner-expanded stream, sorted per level and
        # summed by the bucket kernel with weight 1 (w is in the payload).
        sk, sg = sorted_corner_stream(idx, w, g)                   # [L, B*K]
        sf = torch.empty((L, 0, B * K), dtype=torch.float32, device=g.device)
        grad_flat = bucket_grad_matmul(sk, sf, sg, table_size=S,
                                       input_dim=0)                # [L, C, S]
        grad_table = grad_flat.transpose(1, 2)                     # [L, S, C]
        if not ctx.needs_input_grad[0]:
            return None, grad_table, None

        # Position gradient: analytic through the trilinear weights.
        gv = torch.einsum("blc,blkc->blk", g, vals.to(torch.float32))
        grad_frac = torch.einsum("blk,blkd->bld", gv,
                                 corner_weight_grads(spec, frac))
        scales = torch.as_tensor(spec.scales, device=g.device)
        grad_x01 = torch.sum(grad_frac * scales[None, :, None], dim=1)
        return grad_x01, grad_table, None


def hash_encode_fast(x01: torch.Tensor, table: torch.Tensor,
                     spec: HashGridSpec) -> torch.Tensor:
    """XOR-hash encode with the sort + bucket-kernel backward (no scatter).

    Forward identical to :func:`hash_encode`.  The table gradient sorts the
    2^D-corner-expanded update stream of every level (int32 keys, stable)
    and sums each key's run in stream order with ``bucket_grad_matmul`` at
    ``input_dim=0`` (the weights are already in the payload), so it is
    bitwise reproducible.  Position gradients are analytic.
    """
    return _HashEncodeFast.apply(x01, table, spec)
