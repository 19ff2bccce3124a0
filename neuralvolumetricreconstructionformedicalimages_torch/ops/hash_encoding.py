"""Multiresolution hash-grid encoding (Instant-NGP style), XOR variant.

Port of the JAX ``ops/hash_encoding.py``:

- :class:`HashGridSpec`: per-level scale ``2^l * H - 1``, resolution
  ``ceil(scale) + 1``, per-level live size ``min(2^S, (res+1)^D)`` and the
  uniformly padded ``[L, 2^S, C]`` table initialised U(-1e-4, 1e-4);
- :func:`hash_grid_indices`: corner indices, dense row-major while
  ``(res+1)^D`` fits the table, else the reference's XOR-prime hash; on
  the card one kernel, :func:`xor_index` (``csrc/encode_io.cu``);
- :func:`hash_encode`: the plain gather + weighted sum (autograd's scatter
  is its backward);
- :func:`hash_encode_fast`: the same forward, with the table gradient from
  a stable sort of the corner-expanded update stream
  (:func:`sorted_corner_stream`; on the card one radix sort of the whole
  stream between two kernels, ``csrc/corner_sort.cu``) and the bucket
  kernel at ``input_dim=0`` (deterministic, no atomics), and analytic
  position gradients.

Integer exactness: JAX multiplies and XORs in int32 with wraparound.  On
the CPU the products are taken in int64 (primes and strides as their
uint32 values), whose low 32 bits are JAX's bits; on the card
:func:`xor_index` takes them in uint32 with wraparound, JAX's bits again.
The result is masked to ``S - 1``, so the indices are the same bit for
bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..utils.profiling import layer_range, range_mark
from . import _build

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


@functools.lru_cache(maxsize=None)
def _scales_on(spec: HashGridSpec, device: torch.device) -> torch.Tensor:
    """``spec.scales`` as an f32 [L] tensor on ``device``, made once per
    (spec, device): a step then makes no host-to-device copy, which a
    captured CUDA graph could not replay."""
    return torch.as_tensor(spec.scales, device=device)


@functools.lru_cache(maxsize=None)
def _strides_on(spec: HashGridSpec, device: torch.device) -> torch.Tensor:
    """Dense row-major strides ``(res+1)^d`` [L, D] as int64 on ``device``,
    wrapped mod 2^32 like the reference's uint32 math (cached)."""
    res_p1 = (spec.resolutions + 1).astype(np.uint64)
    strides = np.stack([res_p1 ** d for d in range(spec.input_dim)], -1) & 0xFFFFFFFF
    return torch.as_tensor(strides.astype(np.int64), device=device)


@functools.lru_cache(maxsize=None)
def _dense_on(spec: HashGridSpec, device: torch.device) -> torch.Tensor:
    """``spec.dense_levels`` as a bool [L] tensor on ``device`` (cached)."""
    return torch.as_tensor(spec.dense_levels, device=device)


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
    input gradients need: :func:`xor_index` (its kernel on the card, its
    plain version on the CPU) where :func:`_xor_kernel_route` allows, else
    :func:`_indices_weights_frac_plain`."""
    if _xor_kernel_route(spec, x01):
        return xor_index(spec, x01)
    return _indices_weights_frac_plain(spec, x01)


def _xor_kernel_route(spec: HashGridSpec, x01) -> bool:
    """Whether :func:`_indices_weights_frac` calls :func:`xor_index`: what
    its kernel takes, D = 3, at most 32 levels, and no gradient asked of
    ``x01`` under grad mode (the plain :func:`hash_encode` differentiates
    the weights by autograd).  ``xor_index`` itself chooses the device."""
    return (spec.input_dim == 3 and spec.num_levels <= 32
            and not (x01.requires_grad and torch.is_grad_enabled()))


def _check_xor_index(spec: HashGridSpec, x01: torch.Tensor) -> None:
    """The argument checks of :func:`xor_index` (raise ``ValueError``)."""
    _build.require(spec.input_dim == 3 and x01.dim() == 2 and x01.shape[1] == 3,
                   f"xor_index takes [B, 3] points and input_dim 3, got "
                   f"{tuple(x01.shape)} and input_dim {spec.input_dim}")
    _build.require(spec.num_levels <= 32,
                   f"xor_index takes at most 32 levels, got {spec.num_levels}")


def xor_index(spec: HashGridSpec, x01: torch.Tensor):
    """Corner rows ``idx`` [B, L, 8] int32, weights ``w`` [B, L, 8] f32 and
    in-cell positions ``frac`` [B, L, 3] f32 of ``x01`` [B, 3] in [0, 1],
    bit-equal to :func:`_indices_weights_frac_plain` on the card.  One
    kernel (``csrc/encode_io.cu``), counted in ``LAUNCHES["xor_index"]``;
    the plain version for CPU tensors."""
    if _build.is_cpu(x01):
        return _indices_weights_frac_plain(spec, x01)
    _check_xor_index(spec, x01)
    x = x01.to(torch.float32).contiguous()
    B, L, dev = x.shape[0], spec.num_levels, x.device
    idx = torch.empty((B, L, 8), dtype=torch.int32, device=dev)
    w = torch.empty((B, L, 8), dtype=torch.float32, device=dev)
    frac = torch.empty((B, L, 3), dtype=torch.float32, device=dev)
    _build.LAUNCHES["xor_index"] += 1
    _build.launch("nvr_xor_index", dev, x.data_ptr(), _scales_on(spec, dev).data_ptr(),
                  _strides_on(spec, dev).data_ptr(), _dense_on(spec, dev).data_ptr(),
                  idx.data_ptr(), w.data_ptr(), frac.data_ptr(), L, B, spec.table_size)
    return idx, w, frac


def _indices_weights_frac_plain(spec: HashGridSpec, x01: torch.Tensor):
    """Plain version of :func:`xor_index`, any D: PyTorch ops in int64."""
    from .coherent_hash import _bits_on

    D = spec.input_dim
    S = spec.table_size
    dev = x01.device
    scales = _scales_on(spec, dev)                                 # [L]
    pos = x01[:, None, :].to(torch.float32) * scales[None, :, None]
    pos = pos + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid                                          # [B, L, D]

    bits = _bits_on(D, dev)                                        # [K, D]
    corner = pos_grid.to(torch.int64)[:, :, None, :] + bits[None, None]

    # Interp weight: prod_d (bit ? frac : 1 - frac).
    w = torch.prod(torch.where(bits[None, None] > 0, frac[:, :, None, :],
                               1.0 - frac[:, :, None, :]), dim=-1)  # [B, L, K]

    # Dense row-major index, stride (res+1)^d per dim, the strides wrapped
    # mod 2^32 like the reference's uint32 math (a wrapped stride only
    # occurs on hashed levels, where the dense branch is discarded).  Dense
    # levels are in range by construction ((res+1)^D <= S).
    strides = _strides_on(spec, dev)                               # [L, D]
    idx_dense = torch.sum(corner * strides[None, :, None, :], dim=-1)

    # XOR-prime hash; hashed levels have exactly 2^S entries -> mask.
    primes = _HASH_PRIMES[:D]
    idx_hash = corner[..., 0] * primes[0]
    for d in range(1, D):
        idx_hash = idx_hash ^ (corner[..., d] * primes[d])

    dense = _dense_on(spec, dev)                                    # [L] bool
    idx = torch.where(dense[None, :, None], idx_dense, idx_hash) & (S - 1)
    return idx.to(torch.int32), w, frac


def _he_forward(x01: torch.Tensor, table: torch.Tensor, spec: HashGridSpec):
    """One gather over the padded table and the weighted corner sum:
    features [..., L*C] of points ``x01`` [..., D] and (idx, w, frac, vals
    [B, L, K, C]).  Layer ranges: ``encode.index`` (corners, weights and
    the dense or hashed rows), ``encode.gather`` (the gather and the sum)."""
    L, S, C = table.shape
    with layer_range("encode.index"):
        shape = (*x01.shape[:-1], L * C)
        x01 = x01.reshape(-1, spec.input_dim)
        idx, w, frac = _indices_weights_frac(spec, x01)            # [B, L, K]
    with layer_range("encode.gather"):
        level_off = torch.arange(L, device=idx.device)[None, :, None] * S
        vals = table.reshape(L * S, C)[idx.long() + level_off]     # [B, L, K, C]
        out = torch.sum(w[..., None].to(vals.dtype) * vals, dim=2)  # [B, L, C]
        return out.reshape(shape), (idx, w, frac, vals)


def hash_encode(x01: torch.Tensor, table: torch.Tensor,
                spec: HashGridSpec) -> torch.Tensor:
    """Encode points ``x01`` [..., D] in [0, 1]^D -> features [..., L*C].

    Plain path: one gather over the padded table and a weighted sum;
    autograd's scatter-add is the backward (atomic on the card, so its
    table gradient is not bitwise reproducible there).
    """
    return _he_forward(x01, table, spec)[0]


def sorted_corner_stream(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                         table_size: Optional[int] = None):
    """The XOR backward's update stream, sorted per level.

    Element (b, l, k) has key ``idx[b, l, k]`` (a row below ``table_size``)
    and payload lane c = ``w[b, l, k] * g[b, l, c]``.  Returns the keys [L,
    B*K] int32 sorted stably (ties keep stream order) and the payload [L, C,
    B*K] f32 in that order, both contiguous.  On the card one sort of the
    whole stream by (level, row) between two kernels
    (``csrc/corner_sort.cu``), bit-equal to the plain version and counted
    in ``LAUNCHES["xor_corner_sort"]``; it needs ``table_size``, a power of
    two, for the level's place in the key, at most 32 levels and C = 2.  sk
    and sg are views of one buffer there, which lives while either does.
    The plain version for CPU tensors.
    """
    if _build.is_cpu(idx, w, g):
        return sorted_corner_stream_plain(idx, w, g)
    _check_corner_sort(idx, w, g, table_size)
    B, L, K = idx.shape
    n, sbits, dev = L * B * K, table_size.bit_length() - 1, idx.device
    idx, w, g = idx.contiguous(), w.contiguous(), g.contiguous()
    # the sort's keys, values, other keys and other values; two of them end
    # as sk, the other two as sg
    buf = torch.empty((4, n), dtype=torch.int32, device=dev)
    pay = torch.empty((n, 2), dtype=torch.float32, device=dev)
    temp = torch.empty(_corner_sort_scratch(n, L, sbits, dev), dtype=torch.uint8,
                       device=dev)
    selector = ctypes.c_int(0)
    _build.LAUNCHES["xor_corner_sort"] += 1
    _build.launch("nvr_corner_sort", dev, idx.data_ptr(), w.data_ptr(), g.data_ptr(),
                  buf.data_ptr(), pay.data_ptr(), temp.data_ptr(), temp.numel(),
                  ctypes.addressof(selector), L, B, sbits)
    s = 2 * selector.value
    sk = buf[s].view(L, B * K)
    sg = buf[2 - s:4 - s].view(torch.float32).view(L, 2, B * K)
    return sk, sg


def _check_corner_sort(idx, w, g, table_size) -> None:
    """The argument checks of :func:`sorted_corner_stream` on the card
    (raise ``ValueError``): idx [B, L, 8] int32 with at most 32 levels, as
    ``xor_index`` takes, w [B, L, 8] f32, g [B, L, 2] f32 (C = 2, as the
    sorted encoder's kernels take), a power-of-two ``table_size`` whose
    key, ceil(log2 L) level bits above log2 ``table_size`` row bits, fits
    31 bits, and fewer than 2^31 stream entries."""
    _build.require(idx.dim() == 3 and idx.shape[2] == 8,
                   f"the corner sort takes idx [B, L, 8], got {tuple(idx.shape)}")
    B, L, K = idx.shape
    _build.require(L <= 32, f"the corner sort takes at most 32 levels, got {L}")
    _build.require(idx.dtype == torch.int32,
                   f"the corner sort takes int32 idx, got {idx.dtype}")
    _build.require(w.dtype == torch.float32 and g.dtype == torch.float32,
                   f"the corner sort takes f32 w and g, got {w.dtype} and {g.dtype}")
    _build.require(tuple(w.shape) == (B, L, K) and tuple(g.shape) == (B, L, 2),
                   f"the corner sort takes w [B, L, 8] and g [B, L, 2] for idx "
                   f"{tuple(idx.shape)}, got {tuple(w.shape)} and {tuple(g.shape)}")
    _build.require(isinstance(table_size, int) and table_size > 1
                   and table_size & (table_size - 1) == 0,
                   f"the corner sort takes a power-of-two table_size, got {table_size!r}")
    bits = (L - 1).bit_length() + table_size.bit_length() - 1
    _build.require(bits <= 31, f"the corner sort's keys take ceil(log2 L) + log2 S "
                               f"<= 31 bits, got {bits} (L = {L}, S = {table_size})")
    _build.require(L * B * K < 2 ** 31,
                   f"the corner sort takes fewer than 2^31 entries, got {L * B * K}")


@functools.lru_cache(maxsize=None)
def _corner_sort_scratch(n: int, L: int, sbits: int, device: torch.device) -> int:
    """Bytes of the corner sort's scratch for ``n`` entries (cub's own
    query), asked once per shape and device."""
    out = torch.zeros(1, dtype=torch.int64)
    _build.launch("nvr_corner_sort_scratch", device, n, L, sbits, out.data_ptr())
    return int(out)


def sorted_corner_stream_plain(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """Plain version of :func:`sorted_corner_stream`, any K and C: a stable
    ``torch.sort`` of each level's keys and the payload gathered through
    its positions."""
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
        ctx.x_shape = x01.shape
        return out

    @staticmethod
    def backward(ctx, g):
        from .bucket_matmul import bucket_grad_matmul
        from .coherent_hash import corner_weight_grads

        range_mark("backward.encode.sort")
        idx, w, frac, vals = ctx.saved_tensors
        spec = ctx.spec
        L, S, C = ctx.table_shape
        B, _, K = idx.shape
        g = g.reshape(B, L, C).to(torch.float32)

        # Table gradient: the corner-expanded stream, sorted per level and
        # summed by the bucket kernel with weight 1 (w is in the payload).
        sk, sg = sorted_corner_stream(idx, w, g, S)                # [L, B*K]
        range_mark("backward.encode.bucket")
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
        scales = _scales_on(spec, g.device)
        grad_x01 = torch.sum(grad_frac * scales[None, :, None], dim=1)
        return grad_x01.reshape(ctx.x_shape), grad_table, None


def hash_encode_fast(x01: torch.Tensor, table: torch.Tensor,
                     spec: HashGridSpec) -> torch.Tensor:
    """XOR-hash encode with the sort + bucket-kernel backward (no scatter).

    Forward identical to :func:`hash_encode`.  The table gradient sorts the
    2^D-corner-expanded update stream of every level (int32 keys, stable)
    and sums each key's run in stream order with ``bucket_grad_matmul`` at
    ``input_dim=0`` (the weights are already in the payload), so it is
    bitwise reproducible.  Position gradients are analytic.  Besides the
    forward's layer ranges, the backward marks ``backward.encode.sort``
    (the sorted stream) and ``backward.encode.bucket`` (the bucket kernel
    and what follows it).
    """
    return _HashEncodeFast.apply(x01, table, spec)
