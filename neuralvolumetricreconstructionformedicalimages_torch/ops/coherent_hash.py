"""Coherent (linear) multiresolution hash encoding: index math, the
autograd oracle and the eval-time rolled-table path.

Port of the JAX ``ops/coherent_hash.py``.  The linear hash

    index(g) = (a1*g1 + a2*g2 + a3*g3) mod 2^S

puts the 2^D cell corners of a point at *static* offsets from the cell's
base index, ``index(g + bits) = index(g) + bits . a (mod 2^S)``; the sorted
encoder (``ops/span_gather.py``) and its kernels are built on that.

Integer exactness: the JAX code multiplies in int32 with wraparound and
views the uint32 multipliers as int32.  Here the products are taken in
int64 (the multipliers as their uint32 values) and masked with ``S - 1``;
since ``2^S`` divides ``2^32`` the low bits, and so the base indices, are
the same bit for bit.

``pos = x * scale + 0.5`` is kept as two separate tensor ops: a fused
multiply-add would move ``floor(pos)`` at cell edges.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .hash_encoding import HashGridSpec

# a1 = 1 keeps x-adjacent cells adjacent in the table; a2/a3 are the XOR
# primes of the reference hash reused as linear multipliers.
_LINEAR_MULTIPLIERS = (1, 19349663, 83492791)


@functools.lru_cache(maxsize=None)
def multipliers(spec: HashGridSpec) -> np.ndarray:
    """Per-level linear-hash multipliers [L, D] (int32 bit pattern).

    Dense levels get the dense row-major strides ``(res+1)^d``; hashed
    levels get the coherent multipliers.
    """
    D, L = spec.input_dim, spec.num_levels
    res_p1 = (spec.resolutions + 1).astype(np.uint64)
    out = np.zeros((L, D), np.uint32)
    for l in range(L):
        if spec.dense_levels[l]:
            for d in range(D):
                out[l, d] = (res_p1[l] ** d) & 0xFFFFFFFF
        else:
            out[l] = np.asarray(_LINEAR_MULTIPLIERS[:D], np.uint32)
    return out.view(np.int32)


@functools.lru_cache(maxsize=None)
def corner_bits(input_dim: int) -> np.ndarray:
    """[2^D, D] corner bit patterns, bit d of corner c = (c >> d) & 1."""
    n = 1 << input_dim
    return ((np.arange(n)[:, None] >> np.arange(input_dim)[None, :]) & 1).astype(
        np.int32
    )


@functools.lru_cache(maxsize=None)
def corner_offsets(spec: HashGridSpec) -> np.ndarray:
    """[L, 2^D] table-index offset of each corner from the base index."""
    bits = corner_bits(spec.input_dim).astype(np.int64)  # [2^D, D]
    mult = multipliers(spec).view(np.uint32).astype(np.int64)  # [L, D]
    off = (mult[:, None, :] * bits[None, :, :]).sum(-1)  # [L, 2^D]
    return (off & (spec.table_size - 1)).astype(np.int32)


def _mult_u32(spec: HashGridSpec, device) -> torch.Tensor:
    """Multipliers as their unsigned values in int64, [L, D]."""
    m = multipliers(spec).view(np.uint32).astype(np.int64)
    return torch.as_tensor(m, device=device)


def base_and_frac(spec: HashGridSpec, x01: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base cell index (masked to the table) and fractional position.

    Returns:
      base: int32 [B, L] table index of corner 0 (already mod 2^S)
      frac: float32 [B, L, D] in-cell position
    """
    scales = torch.as_tensor(spec.scales, device=x01.device)  # [L]
    pos = x01[:, None, :].to(torch.float32) * scales[None, :, None]
    pos = pos + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    g = pos_grid.to(torch.int64)
    raw = (g * _mult_u32(spec, x01.device)[None]).sum(-1)  # [B, L]
    return (raw & (spec.table_size - 1)).to(torch.int32), frac


def base_and_frac_t(spec: HashGridSpec, x01: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Level-major variant of :func:`base_and_frac`.

    Returns ``base`` [L, B] int32 and ``frac`` [L, D, B] f32 -- the layout
    the per-level sorts consume directly.
    """
    xT = x01.t().to(torch.float32)                                # [D, B]
    scales = torch.as_tensor(spec.scales, device=x01.device)      # [L]
    pos = xT[None, :, :] * scales[:, None, None]                  # [L, D, B]
    pos = pos + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    g = pos_grid.to(torch.int64)
    raw = (g * _mult_u32(spec, x01.device)[:, :, None]).sum(1)    # [L, B]
    return (raw & (spec.table_size - 1)).to(torch.int32), frac.contiguous()


def corner_weights(spec: HashGridSpec, frac: torch.Tensor) -> torch.Tensor:
    """Trilinear weights [B, L, 2^D] from frac [B, L, D]."""
    bits = torch.as_tensor(corner_bits(spec.input_dim), device=frac.device)
    t = torch.where(bits[None, None] > 0, frac[:, :, None, :],
                    1.0 - frac[:, :, None, :])                    # [B, L, K, D]
    return torch.prod(t, dim=-1)


def coherent_encode_reference(x01: torch.Tensor, table: torch.Tensor,
                              spec: HashGridSpec) -> torch.Tensor:
    """Plain oracle for the coherent hash (autograd in both arguments).

    Gathers the 2^D corner rows of every (point, level) and interpolates;
    [B, D] in [0, 1] -> [B, L*C] float32.
    """
    B = x01.shape[0]
    L, S, C = table.shape
    base, frac = base_and_frac(spec, x01)
    w = corner_weights(spec, frac)                                # [B, L, K]
    offs = torch.as_tensor(corner_offsets(spec), device=x01.device)
    idx = (base[:, :, None].long() + offs[None].long()) & (S - 1)  # [B, L, K]
    level_off = torch.arange(L, device=x01.device)[None, :, None] * S
    vals = table.reshape(L * S, C)[idx + level_off]               # [B, L, K, C]
    out = torch.sum(w[..., None].to(vals.dtype) * vals, dim=2)    # [B, L, C]
    return out.reshape(B, L * C).to(torch.float32)


# ---------------------------------------------------------------------------
# Eval path: prebuilt rolled table (plain PyTorch, no kernel)
# ---------------------------------------------------------------------------

def build_rolled_table(table: torch.Tensor, spec: HashGridSpec,
                       dtype=torch.float32) -> torch.Tensor:
    """[L, S, C] canonical table -> [L, S, 2^D * C] rolled corner table.

    ``rolled[l, i, k*C + c] = table[l, (i + off[l, k]) % S, c]``: row ``i``
    holds every corner feature of base index ``i``.
    """
    L, S, C = table.shape
    K = 1 << spec.input_dim
    offs = corner_offsets(spec)
    table = table.to(dtype)
    per_corner = torch.stack([
        torch.stack([torch.roll(table[l], -int(offs[l, k]), dims=0)
                     for k in range(K)])
        for l in range(L)
    ])                                                            # [L, K, S, C]
    return per_corner.permute(0, 2, 1, 3).reshape(L, S, K * C)


# Points per gather chunk of the prebuilt path: bounds the [B, L, K*C]
# gathered rows of one chunk (~200 MB at 16 levels x 16 features in f32).
_FWD_CHUNK = 196_608


def _interpolate_chunk(x01, rolled, spec: HashGridSpec, n_channels: int):
    B = x01.shape[0]
    L = rolled.shape[0]
    K = 1 << spec.input_dim
    base, frac = base_and_frac(spec, x01)
    w = corner_weights(spec, frac)                                # [B, L, K]
    lvl = torch.arange(L, device=x01.device)[None, :]
    vals = rolled[lvl, base.long()]                               # [B, L, K*C]
    vals = vals.reshape(B, L, K, n_channels).to(torch.float32)
    out = torch.einsum("blk,blkc->blc", w, vals)
    return out.reshape(B, L * n_channels)


def coherent_encode_prebuilt(x01: torch.Tensor, rolled: torch.Tensor,
                             spec: HashGridSpec) -> torch.Tensor:
    """Forward-only encode against a PREBUILT rolled table (eval path).

    Build the table once with :func:`build_rolled_table` outside the tiling
    loops of ``render_image`` / ``query_field`` and pass it here.  Not
    differentiable wrt the table.
    """
    C = rolled.shape[-1] >> spec.input_dim
    parts = [_interpolate_chunk(c, rolled, spec, C)
             for c in torch.split(x01, _FWD_CHUNK)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)
