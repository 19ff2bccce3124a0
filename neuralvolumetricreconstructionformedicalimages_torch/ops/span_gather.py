"""Sorted span-gather forward for the coherent hash encoder, and the
encoder's autograd Function.

Port of the JAX ``ops/span_gather.py``.  Pipeline of :func:`sorted_encode`:

1. ``roll_broadcast_fm`` builds the feature-major rolled table
   ``R[l, k*C + c, s] = table[l, (s + off[l, k]) % S, c]`` (bf16 on the
   main path);
2. per level, a stable integer sort of the base indices (``torch.sort``)
   gives the sorted keys and the permutation;
3. :func:`span_gather_sorted` interpolates every sorted point from the
   2^D corner features of its key's row;
4. an index copy by the saved permutation un-permutes the features (the
   JAX code sorts a second time; it is the same function).

Backward wrt the table (the positions get no gradient on this path): the
forward's permutation sorts the output gradient, ``bucket_grad_matmul``
segment-sums it into the rolled layout and ``unroll_reduce_fm`` brings it
back to the canonical ``[L, S, C]`` table.

Sort keys are int32 and the sort is stable; the JAX code's f32 keys are
exact only below 2^24.  Tie order only changes the order of the f32 sums.
"""

from __future__ import annotations

import torch

from . import _build
from .bucket_matmul import bucket_grad_matmul
from .coherent_hash import base_and_frac_t, corner_bits
from .hash_encoding import HashGridSpec
from .roll_kernels import (
    _PAD,
    _unroll_sum,
    roll_broadcast_fm,
    roll_broadcast_fm_plain,
    unroll_reduce_fm,
)

_PACK_HI = (2047.0, 2047.0, 1023.0)


# ---------------------------------------------------------------------------
# The span-gather kernel and its plain version
# ---------------------------------------------------------------------------

def _trilerp_sorted(frac: torch.Tensor, vals: torch.Tensor, K: int, C: int):
    """``out[l, c] = sum_k w_k * vals[l, k*C + c]`` with the weights and the
    k order of the kernel.  frac [L, D, B] f32, vals [L, K*C, B] f32."""
    D = frac.shape[1]
    bits = corner_bits(D)
    w = []
    for k in range(K):
        wk = torch.ones_like(frac[:, 0])
        for d in range(D):
            t = frac[:, d]
            wk = wk * (t if bits[k, d] else 1.0 - t)
        w.append(wk)
    outs = []
    for c in range(C):
        acc = w[0] * vals[:, c]
        for k in range(1, K):
            acc = acc + w[k] * vals[:, k * C + c]
        outs.append(acc)
    return torch.stack(outs, dim=1)                               # [L, C, B]


def span_gather_sorted_plain(sorted_keys: torch.Tensor,
                             sorted_frac: torch.Tensor,
                             rolled_fm: torch.Tensor, *,
                             input_dim: int) -> torch.Tensor:
    """Plain version of :func:`span_gather_sorted`: gather the key columns,
    form the weights, sum the corners in k order."""
    L, B = sorted_keys.shape
    K = 1 << int(input_dim)
    F = rolled_fm.shape[1]
    if sorted_frac.dtype == torch.int32:
        frac = unpack_frac_t(sorted_frac.reshape(L, B))
    else:
        frac = sorted_frac
    idx = sorted_keys.long()[:, None, :].expand(L, F, B)
    vals = torch.gather(rolled_fm, 2, idx).to(torch.float32)     # [L, F, B]
    return _trilerp_sorted(frac, vals, K, F // K)


def span_gather_sorted(sorted_keys: torch.Tensor, sorted_frac: torch.Tensor,
                       rolled_fm: torch.Tensor, *,
                       input_dim: int) -> torch.Tensor:
    """Gather + trilerp over a PRE-SORTED per-level stream.

    Args:
      sorted_keys: [L, B] int32, ascending per level, in [0, S).
      sorted_frac: [L, D, B] f32 in-cell positions in sorted order, OR
        [L, 1, B] int32 11/11/10-bit packed fracs (D must be 3).
      rolled_fm: [L, K*C, S] feature-major rolled table (f32 or bf16),
        row ordering ``f = k*C + c``.
      input_dim: D.

    Returns:
      feats_sorted [L, C, B] f32 -- interpolated features, sorted order.
    """
    if _build.is_cpu(sorted_keys, sorted_frac, rolled_fm):
        return span_gather_sorted_plain(sorted_keys, sorted_frac, rolled_fm,
                                        input_dim=input_dim)
    L, B = sorted_keys.shape
    D = int(input_dim)
    K = 1 << D
    _, F, S = rolled_fm.shape
    C = F // K
    packed = sorted_frac.dtype == torch.int32
    req = _build.require
    req(sorted_keys.dtype == torch.int32, "sorted_keys must be int32")
    req(rolled_fm.dtype in (torch.float32, torch.bfloat16),
        "rolled_fm must be float32 or bfloat16")
    req(rolled_fm.shape[0] == L and C * K == F and C > 0,
        f"rolled_fm shape {tuple(rolled_fm.shape)} does not fit {L} levels "
        f"of 2^{D} corners")
    if packed:
        req(D == 3 and tuple(sorted_frac.shape) == (L, 1, B),
            "packed fracs must be [L, 1, B] int32 with input_dim 3")
    else:
        req(sorted_frac.dtype == torch.float32 and 1 <= D <= 3
            and tuple(sorted_frac.shape) == (L, D, B),
            f"sorted_frac must be [L, D, B] float32, got "
            f"{tuple(sorted_frac.shape)} {sorted_frac.dtype}")
    req(all(t.is_contiguous() for t in (sorted_keys, sorted_frac, rolled_fm)),
        "inputs must be contiguous")
    out = torch.empty((L, C, B), dtype=torch.float32, device=sorted_keys.device)
    _build.LAUNCHES["span_gather_sorted"] += 1
    _build.launch("span_gather", "nvr_span_gather_sorted",
                  [_build.VOIDP] * 4 + [_build.INT] * 5
                  + [_build.I64, _build.I64, _build.VOIDP],
                  sorted_keys.device, sorted_keys.data_ptr(), sorted_frac.data_ptr(),
                  rolled_fm.data_ptr(), out.data_ptr(), int(packed),
                  int(rolled_fm.dtype == torch.bfloat16), L, D, C, B, S)
    return out


# ---------------------------------------------------------------------------
# Feature-major rolled table build / gradient reduce oracles
# ---------------------------------------------------------------------------

def roll_broadcast_reference(table: torch.Tensor, spec: HashGridSpec,
                             dtype=torch.float32) -> torch.Tensor:
    """Plain oracle for ``roll_kernels.roll_broadcast_fm``:
    ``R[l, k*C + c, s] = table[l, (s + off[l, k]) % S, c]``."""
    return roll_broadcast_fm_plain(table, spec, dtype)


def unroll_reduce_reference(grad_rolled: torch.Tensor,
                            spec: HashGridSpec) -> torch.Tensor:
    """Plain oracle for ``roll_kernels.unroll_reduce_fm`` (unextended input):
    [L, K*C, S] -> canonical [L, S, C],
    ``grad[l, j, c] = sum_k grad_rolled[l, k*C + c, (j - off[l, k]) % S]``."""
    C = grad_rolled.shape[1] >> spec.input_dim
    return _unroll_sum(grad_rolled, spec, C)


# ---------------------------------------------------------------------------
# Payload packing
# ---------------------------------------------------------------------------

def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> int32 with the same bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _pack_q(q0, q1, q2) -> torch.Tensor:
    return _wrap_i32(q0.long() | (q1.long() << 11) | (q2.long() << 22))


def pack_frac(frac: torch.Tensor) -> torch.Tensor:
    """[..., 3] f32 fracs in [0, 1) -> [...] int32, 11/11/10-bit fixed point
    (quantisation ~2.4e-4 of the in-cell position)."""
    hi = torch.tensor(_PACK_HI, device=frac.device)
    q = torch.minimum(torch.clamp(frac * hi + 0.5, min=0.0), hi).to(torch.int32)
    return _pack_q(q[..., 0], q[..., 1], q[..., 2])


def _unpack3(pk: torch.Tensor):
    fx = (pk & 2047).to(torch.float32) * (1.0 / 2047.0)
    fy = ((pk >> 11) & 2047).to(torch.float32) * (1.0 / 2047.0)
    fz = ((pk >> 22) & 1023).to(torch.float32) * (1.0 / 1023.0)
    return fx, fy, fz


def unpack_frac(pk: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_frac`: [...] int32 -> [..., 3] f32."""
    return torch.stack(_unpack3(pk), dim=-1)


def pack_frac_t(frac_t: torch.Tensor) -> torch.Tensor:
    """Level-major :func:`pack_frac`: [L, 3, B] f32 -> [L, B] int32."""
    hi = torch.tensor(_PACK_HI, device=frac_t.device)[None, :, None]
    q = torch.minimum(torch.clamp(frac_t * hi + 0.5, min=0.0), hi).to(torch.int32)
    return _pack_q(q[:, 0], q[:, 1], q[:, 2])


def unpack_frac_t(pk: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_frac_t`: [L, B] int32 -> [L, 3, B] f32."""
    return torch.stack(_unpack3(pk), dim=1)


def _pack_feats(fs: torch.Tensor) -> torch.Tensor:
    """[L, C=2, B] f32 -> [L, B] int32 (bf16 pair): c0 high, c1 low."""
    u = fs.to(torch.bfloat16).view(torch.int16).long() & 0xFFFF   # [L, 2, B]
    return _wrap_i32((u[:, 0] << 16) | u[:, 1])


def _unpack_feats(pk: torch.Tensor) -> torch.Tensor:
    """[B, L] int32 -> [B, L, 2] f32 (inverse of :func:`_pack_feats`)."""
    u = pk.long() & 0xFFFFFFFF

    def half(h):
        h = torch.where(h >= 2 ** 15, h - 2 ** 16, h)
        return h.to(torch.int16).view(torch.bfloat16)

    return torch.stack([half(u >> 16), half(u & 0xFFFF)], dim=-1).to(torch.float32)


# ---------------------------------------------------------------------------
# Full sorted-forward encode with the bucket backward
# ---------------------------------------------------------------------------

def _encode_sorted(base_t, frac_t, rolled_fm, input_dim: int, pack: bool):
    """Point-order features [B, L*C] plus what the backward reuses: the
    sorted keys, the permutation and the sorted fracs (packed int32 [L, B]
    when ``pack``, else f32 [L, D, B])."""
    L, B = base_t.shape
    D = int(input_dim)
    K = 1 << D
    C = rolled_fm.shape[1] // K
    sk, perm = torch.sort(base_t, dim=-1, stable=True)           # int32, int64
    if pack and D == 3 and C == 2:
        spf = torch.gather(pack_frac_t(frac_t), 1, perm)         # [L, B] int32
        feats_sorted = span_gather_sorted(
            sk, spf[:, None, :], rolled_fm, input_dim=D)         # [L, C, B]
        packed_sorted = _pack_feats(feats_sorted)                # [L, B]
        packed = torch.empty_like(packed_sorted).scatter_(1, perm, packed_sorted)
        out = _unpack_feats(packed.t())                          # [B, L, 2]
        return out.reshape(B, L * C), (sk, perm, spf)
    sfr = torch.gather(frac_t, 2, perm[:, None, :].expand(L, D, B))
    feats_sorted = span_gather_sorted(sk, sfr, rolled_fm, input_dim=D)
    feats = torch.empty_like(feats_sorted).scatter_(
        2, perm[:, None, :].expand(L, C, B), feats_sorted)
    return feats.permute(2, 0, 1).reshape(B, L * C), (sk, perm, sfr)


def sorted_encode_features(base_t: torch.Tensor, frac_t: torch.Tensor,
                           rolled_fm: torch.Tensor, input_dim: int,
                           pack: bool = True) -> torch.Tensor:
    """Point-order features [B, L*C] via sort -> span kernel -> un-permute.

    Args:
      base_t: [L, B] int32 level-major base indices (``base_and_frac_t``).
      frac_t: [L, D, B] f32 level-major in-cell positions.

    ``pack=True`` (D = 3, C = 2) carries the fracs as one 11/11/10-bit
    int32 and the features as one bf16 pair: features are then rounded to
    bf16.  ``pack=False`` keeps everything f32.
    """
    return _encode_sorted(base_t, frac_t, rolled_fm, input_dim, pack)[0]


class _SortedEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x01, table, spec, table_dtype, pack):
        rolled_fm = roll_broadcast_fm(table.detach(), spec, table_dtype)
        base_t, frac_t = base_and_frac_t(spec, x01.detach())
        pack = bool(pack) and spec.input_dim == 3 and spec.level_dim == 2
        out, (sk, perm, sfrac) = _encode_sorted(
            base_t, frac_t, rolled_fm, spec.input_dim, pack)
        ctx.save_for_backward(sk, perm, sfrac)
        ctx.spec = spec
        ctx.pack = pack
        ctx.n_channels = table.shape[2]
        return out

    @staticmethod
    def backward(ctx, g):
        sk, perm, sfrac = ctx.saved_tensors
        spec = ctx.spec
        L, B = sk.shape
        C = ctx.n_channels
        # The packed fracs decode to the quantised positions the forward
        # interpolated with, so the backward differentiates that function.
        sf = unpack_frac_t(sfrac) if ctx.pack else sfrac
        gt = g.reshape(B, L, C).permute(1, 2, 0).to(torch.float32)  # [L, C, B]
        sg = torch.gather(gt, 2, perm[:, None, :].expand(L, C, B))
        grad_rolled = bucket_grad_matmul(
            sk, sf, sg, table_size=spec.table_size, input_dim=spec.input_dim,
            extend_cols=_PAD)                                    # [L, K*C, S+pad]
        grad_table = unroll_reduce_fm(grad_rolled, spec, C)      # [L, S, C]
        return None, grad_table, None, None, None


def sorted_encode(x01: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                  table_dtype=torch.float32, pack: bool = True) -> torch.Tensor:
    """Coherent hash encode, sorted span-gather forward: [B, D] -> [B, L*C].

    Differentiable wrt ``table`` only (bucket + unroll backward).  Raises
    if ``x01`` requires grad: this path computes no position gradients
    (the JAX package returns zeros for them silently).
    """
    if torch.is_grad_enabled() and x01.requires_grad:
        raise NotImplementedError(
            "sorted_encode gives no gradient wrt positions; set the encoder's "
            "input_grads: True to take the coherent_encode path, which does")
    return _SortedEncode.apply(x01, table, spec, table_dtype, pack)
