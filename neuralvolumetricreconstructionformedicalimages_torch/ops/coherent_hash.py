"""Coherent (linear) multiresolution hash encoding: index math, the
autograd oracle, the rolled-table fast path and the eval-time path.

Port of the JAX ``ops/coherent_hash.py``.  The linear hash

    index(g) = (a1*g1 + a2*g2 + a3*g3) mod 2^S

puts the 2^D cell corners of a point at *static* offsets from the cell's
base index, ``index(g + bits) = index(g) + bits . a (mod 2^S)``; the sorted
encoder (``ops/span_gather.py``) and its kernels are built on that, and so
is the rolled path here: a table whose row ``i`` holds all 2^D corner
features of base index ``i`` turns each (point, level) lookup into one
wide-row gather.

- :func:`coherent_encode`: rolled forward; backward by a stable integer
  sort, ``bucket_grad_matmul`` into the rolled layout (rounded to the
  table dtype, as JAX rounds it) and ``unroll_reduce_fm``, plus analytic
  position gradients -- the only fast path that gives them;
- :func:`coherent_encode_takevjp`: the same forward from differentiable
  ops only (``torch.roll``/``stack`` on the live table), autograd backward,
  no kernel.

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


def corner_weight_grads(spec: HashGridSpec, frac: torch.Tensor) -> torch.Tensor:
    """d(weight)/d(frac): [B, L, 2^D, D].

    ``dw_k/df_d = sign_d(k) * prod_{e != d} t_e(k)`` with ``t_e = bit ? f :
    1 - f``, by explicit products (no division: stable at f in {0, 1}).
    """
    D = spec.input_dim
    bits = torch.as_tensor(corner_bits(D), device=frac.device)
    t = torch.where(bits[None, None] > 0, frac[:, :, None, :],
                    1.0 - frac[:, :, None, :])                    # [B, L, K, D]
    sign = torch.where(bits > 0, 1.0, -1.0).to(frac.dtype)        # [K, D]
    grads = []
    for d in range(D):
        prod = sign[:, d].expand(t.shape[:-1])
        for e in range(D):
            if e != d:
                prod = prod * t[..., e]
        grads.append(prod)
    return torch.stack(grads, dim=-1)


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
# Rolled-table path
# ---------------------------------------------------------------------------

def build_rolled_table(table: torch.Tensor, spec: HashGridSpec,
                       dtype=torch.float32) -> torch.Tensor:
    """[L, S, C] canonical table -> [L, S, 2^D * C] rolled corner table.

    ``rolled[l, i, k*C + c] = table[l, (i + off[l, k]) % S, c]``: row ``i``
    holds every corner feature of base index ``i``.  Differentiable (one
    ``torch.roll`` per (level, corner)); the take path backpropagates
    through it.
    """
    L, S, C = table.shape
    K = 1 << spec.input_dim
    offs = corner_offsets(spec)
    # One unbind, not L indexings: autograd would zero-fill and add a
    # full-table gradient for every ``table[l]``.
    levels = table.to(dtype).unbind(0)
    per_corner = torch.stack([
        torch.stack([torch.roll(levels[l], -int(offs[l, k]), dims=0)
                     for k in range(K)])
        for l in range(L)
    ])                                                            # [L, K, S, C]
    return per_corner.permute(0, 2, 1, 3).reshape(L, S, K * C)


# Points per gather chunk.  In JAX this pinned XLA's gather emitter to a
# shape it scheduled well; PyTorch has no such cliff, and the numerics are
# the same either way.  It stays because it bounds the f32 temporaries of
# one chunk (the [B, L, K*C] rows cast to f32, ~200 MB at 16 levels x 16
# features) on the eval path, which encodes up to 786k points per tile.
_FWD_CHUNK = 196_608


def _interpolate_chunk(x01, rolled, spec: HashGridSpec, n_channels: int):
    B = x01.shape[0]
    L = rolled.shape[0]
    K = 1 << spec.input_dim
    base, frac = base_and_frac(spec, x01)
    w = corner_weights(spec, frac)                                # [B, L, K]
    lvl = torch.arange(L, device=x01.device)[None, :]
    vals = rolled[lvl, base.long()]                               # [B, L, K*C]
    vals_kc = vals.reshape(B, L, K, n_channels).to(torch.float32)
    # The f32 trilerp as a multiply and a sum over the K corners.  As an
    # einsum, PyTorch runs it as a batched 1 x K by K x C product: cuBLAS
    # gemv calls taking 3.85 ms of a 10.5 ms step on an H100, and GEMMs in
    # its backward on the take path.
    out = torch.sum(w[..., None] * vals_kc, dim=2)                # [B, L, C]
    return out.reshape(B, L * n_channels), base, frac, vals


def _interpolate(x01, rolled, spec: HashGridSpec, n_channels: int):
    """Wide-row gather from ``rolled`` + trilerp, in ``_FWD_CHUNK``-point
    chunks.  Returns (out [B, L*C] f32, base [B, L], frac [B, L, D],
    vals [B, L, K*C] in the rolled table's dtype)."""
    parts = [_interpolate_chunk(c, rolled, spec, n_channels)
             for c in torch.split(x01, _FWD_CHUNK)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(4))


def coherent_encode_prebuilt(x01: torch.Tensor, rolled: torch.Tensor,
                             spec: HashGridSpec) -> torch.Tensor:
    """Forward-only encode against a PREBUILT rolled table (eval path).

    Build the table once with :func:`build_rolled_table` outside the tiling
    loops of ``render_image`` / ``query_field`` and pass it here.  Not
    differentiable wrt the table.
    """
    C = rolled.shape[-1] >> spec.input_dim
    return _interpolate(x01, rolled, spec, C)[0]


def _backward(spec: HashGridSpec, table_dtype, C: int, res, g: torch.Tensor,
              need_x: bool):
    """Table gradient by sort + bucket + unroll; analytic position gradient
    through the trilinear weights (only when ``need_x``)."""
    from .bucket_matmul import bucket_grad_matmul
    from .roll_kernels import _PAD, unroll_reduce_fm

    base, frac, vals = res
    B, L = base.shape
    D = spec.input_dim
    K = 1 << D
    g = g.reshape(B, L, C).to(torch.float32)

    # Stable int32 sort (JAX's unstable f32 sort only permutes the order of
    # the sums within a column).
    sk, perm = torch.sort(base.t(), dim=-1, stable=True)          # [L, B]
    sf = torch.gather(frac.permute(1, 2, 0), 2,
                      perm[:, None, :].expand(L, D, B))            # [L, D, B]
    sg = torch.gather(g.permute(1, 2, 0), 2,
                      perm[:, None, :].expand(L, C, B))            # [L, C, B]
    # Rounded to the table dtype before the unroll, where JAX rounds it.
    grad_rolled = bucket_grad_matmul(
        sk.contiguous(), sf, sg,
        table_size=spec.table_size, input_dim=D, out_dtype=table_dtype,
        extend_cols=_PAD)                                          # [L, K*C, S+pad]
    grad_table = unroll_reduce_fm(grad_rolled, spec, C)           # [L, S, C] f32
    if not need_x:
        return None, grad_table

    # dout[c]/df[d] = sum_k dw_k/df_d * val[k, c]; f32 einsums (TF32 is
    # off: ``train.trainer.pin_fp32`` and PyTorch's default)
    vals_kc = vals.reshape(B, L, K, C).to(torch.float32)
    gv = torch.einsum("blc,blkc->blk", g, vals_kc)                 # [B, L, K]
    grad_frac = torch.einsum("blk,blkd->bld", gv,
                             corner_weight_grads(spec, frac))     # [B, L, D]
    scales = torch.as_tensor(spec.scales, device=g.device)
    grad_x01 = torch.sum(grad_frac * scales[None, :, None], dim=1)  # [B, D]
    return grad_x01, grad_table


class _CoherentEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x01, table, spec, table_dtype):
        from .roll_kernels import roll_broadcast_fm

        L, S, C = table.shape
        # The roll kernel's feature-major table, transposed once: the values
        # of build_rolled_table without its 128 torch.roll calls.
        rolled = roll_broadcast_fm(table.contiguous(), spec,
                                   table_dtype).transpose(1, 2).contiguous()
        out, base, frac, vals = _interpolate(x01, rolled, spec, C)
        ctx.save_for_backward(base, frac, vals)
        ctx.spec = spec
        ctx.table_dtype = table_dtype
        ctx.n_channels = C
        return out

    @staticmethod
    def backward(ctx, g):
        gx, gt = _backward(ctx.spec, ctx.table_dtype, ctx.n_channels,
                           ctx.saved_tensors, g, ctx.needs_input_grad[0])
        return gx, gt, None, None


def coherent_encode(x01: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                    table_dtype=torch.float32) -> torch.Tensor:
    """Fast coherent hash encoding: [B, D] in [0, 1] -> [B, L*C] f32.

    Forward: the rolled table (``roll_broadcast_fm``) and one wide-row
    gather per (point, level).  Backward: table gradient by the
    deterministic sort + ``bucket_grad_matmul`` + ``unroll_reduce_fm``;
    position gradient analytic through the trilinear weights.  Numerics
    match :func:`coherent_encode_reference` to the rolled-table dtype.
    """
    return _CoherentEncode.apply(x01, table, spec, table_dtype)


def coherent_encode_takevjp(x01: torch.Tensor, table: torch.Tensor,
                            spec: HashGridSpec,
                            table_dtype=torch.float32) -> torch.Tensor:
    """Rolled-table forward with plain autograd backward (no kernel).

    The same forward as :func:`coherent_encode`, built from differentiable
    ops only (:func:`build_rolled_table` on the live table, the gather and
    the weighted sum), so the backward is autograd's: an accumulating
    ``index_put_`` of the wide rows, then the roll adjoints.  On the card
    that scatter is atomic, so the table gradient is not bitwise
    reproducible.
    """
    rolled = build_rolled_table(table, spec, table_dtype)
    return _interpolate(x01, rolled, spec, table.shape[2])[0]
