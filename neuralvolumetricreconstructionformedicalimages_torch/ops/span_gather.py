"""Sorted span-gather forward for the coherent hash encoder, and the
encoder's autograd Function.

Port of the JAX ``ops/span_gather.py``.  Pipeline of :func:`sorted_encode`:

1. per level, a stable integer sort of the base indices (``torch.sort``)
   gives the sorted keys and the permutation;
2. :func:`span_gather_sorted_table` interpolates every sorted point from
   the 2^D corner features of its key, read from the canonical ``[L, S,
   C]`` table at the corners' offsets and rounded to the table dtype;
3. an index copy by the saved permutation un-permutes the features (the
   JAX code sorts a second time; it is the same function).

With packed positions (D = 3, C = 2, every shipped configuration) the
work around the sort runs in kernels: :func:`encode_index` writes the
base indices and the packed positions, :func:`span_gather_point_order`
reads the positions and writes the features as bf16 pairs through the
permutation (steps 2 and 3 in one pass), :func:`unpack_feats_t`
transposes and widens them to [B, L*C] f32, and the backward's
:func:`transpose_grad_t` and :func:`encode_grad_permute` bring the output
gradient and the unpacked positions to sorted order.  The CPU runs the
same sequence, each wrapper through its plain version.  Only f32
positions and :func:`sorted_encode_features` gather and scatter with
PyTorch ops (:func:`_encode_sorted`).

The JAX forward first builds the feature-major rolled table
``R[l, k*C + c, s] = table[l, (s + off[l, k]) % S, c]`` (``roll_broadcast_fm``)
and gathers from it (:func:`span_gather_sorted`): the TPU has no gather
unit, and R puts every corner of a key in one row.  The card gathers
directly, so the main path skips R; both gathers are one kernel in two
addressing modes and are bit-equal.  :func:`sorted_encode_features` keeps
the JAX signature and the rolled route.

Backward wrt the table (the positions get no gradient on this path): the
forward's permutation sorts the output gradient, ``bucket_grad_matmul``
segment-sums it into the rolled layout and ``unroll_reduce_fm`` brings it
back to the canonical ``[L, S, C]`` table.

Sort keys are int32 and the sort is stable; the JAX code's f32 keys are
exact only below 2^24.  Tie order only changes the order of the f32 sums.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .bucket_matmul import bucket_grad_matmul
from .coherent_hash import (
    _mult_on,
    _offsets_on,
    base_and_frac_t,
    corner_bits,
    corner_offsets,
)
from ..utils.profiling import layer_range, range_mark
from .hash_encoding import HashGridSpec, _scales_on
from .roll_kernels import (
    _PAD,
    _unroll_sum,
    roll_broadcast_fm_plain,
    unroll_reduce_fm,
)

_PACK_HI = (2047.0, 2047.0, 1023.0)


@functools.lru_cache(maxsize=None)
def _pack_hi_on(device: torch.device) -> torch.Tensor:
    """``_PACK_HI`` as an f32 [3] tensor on ``device``, made once per device
    (a step then copies nothing from the host)."""
    return torch.tensor(_PACK_HI, device=device)


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


def _check_stream(sorted_keys, sorted_frac, D: int) -> bool:
    """Check the sorted keys and fracs a kernel mode takes; True when the
    fracs are packed."""
    L, B = sorted_keys.shape
    packed = sorted_frac.dtype == torch.int32
    req = _build.require
    req(sorted_keys.dtype == torch.int32, "sorted_keys must be int32")
    if packed:
        req(D == 3 and tuple(sorted_frac.shape) == (L, 1, B),
            "packed fracs must be [L, 1, B] int32 with input_dim 3")
    else:
        req(sorted_frac.dtype == torch.float32 and 1 <= D <= 3
            and tuple(sorted_frac.shape) == (L, D, B),
            f"sorted_frac must be [L, D, B] float32, got "
            f"{tuple(sorted_frac.shape)} {sorted_frac.dtype}")
    return packed


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
    packed = _check_stream(sorted_keys, sorted_frac, D)
    req = _build.require
    req(rolled_fm.dtype in (torch.float32, torch.bfloat16),
        "rolled_fm must be float32 or bfloat16")
    req(rolled_fm.shape[0] == L and C * K == F and C > 0,
        f"rolled_fm shape {tuple(rolled_fm.shape)} does not fit {L} levels "
        f"of 2^{D} corners")
    req(all(t.is_contiguous() for t in (sorted_keys, sorted_frac, rolled_fm)),
        "inputs must be contiguous")
    out = torch.empty((L, C, B), dtype=torch.float32, device=sorted_keys.device)
    _build.LAUNCHES["span_gather_sorted"] += 1
    _build.launch("nvr_span_gather_sorted", sorted_keys.device,
                  sorted_keys.data_ptr(), sorted_frac.data_ptr(),
                  rolled_fm.data_ptr(), out.data_ptr(), int(packed),
                  int(rolled_fm.dtype == torch.bfloat16), L, D, C, B, S)
    return out


def span_gather_sorted_table_plain(sorted_keys: torch.Tensor,
                                   sorted_frac: torch.Tensor,
                                   table: torch.Tensor, spec: HashGridSpec,
                                   table_dtype=torch.float32) -> torch.Tensor:
    """Plain version of :func:`span_gather_sorted_table`: gather each
    corner's row ``(key + off[l, k]) % S`` of the table cast to
    ``table_dtype``, then the weights and the k-order sum of
    :func:`span_gather_sorted_plain`."""
    L, B = sorted_keys.shape
    _, S, C = table.shape
    D = spec.input_dim
    if sorted_frac.dtype == torch.int32:
        frac = unpack_frac_t(sorted_frac.reshape(L, B))
    else:
        frac = sorted_frac
    offs = torch.as_tensor(corner_offsets(spec), dtype=torch.int64,
                           device=table.device)                  # [L, K]
    rows = (sorted_keys.long()[:, None, :] + offs[:, :, None]) % S  # [L, K, B]
    rows = rows + torch.arange(L, device=table.device)[:, None, None] * S
    flat = rows[:, :, None, :] * C + torch.arange(C, device=table.device)[:, None]
    vals = table.to(table_dtype).reshape(-1)[flat]               # [L, K, C, B]
    return _trilerp_sorted(frac, vals.reshape(L, -1, B).to(torch.float32),
                           1 << D, C)


def span_gather_sorted_table(sorted_keys: torch.Tensor,
                             sorted_frac: torch.Tensor, table: torch.Tensor,
                             spec: HashGridSpec,
                             table_dtype=torch.float32) -> torch.Tensor:
    """:func:`span_gather_sorted` reading the canonical table in place of
    its rolled copy: corner k of key s is ``table[l, (s + off[l, k]) % S]``,
    rounded to ``table_dtype`` (f32 or bf16) as ``roll_broadcast_fm``
    rounds it.  Bit-equal to ``span_gather_sorted(..., roll_broadcast_fm(
    table, spec, table_dtype), ...)``; the same kernel in another
    addressing mode, counted apart, under
    ``LAUNCHES["span_gather_sorted[table]"]``, so a run shows which mode
    it launched.

    Args:
      sorted_keys: [L, B] int32, ascending per level, in [0, S).
      sorted_frac: [L, D, B] f32 or [L, 1, B] int32 packed (D = 3), as for
        :func:`span_gather_sorted`.
      table: [L, S, C] f32 canonical table (S a power of two, as every
        ``HashGridSpec`` has).
      spec: the grid; gives D and the corner offsets.

    Returns:
      feats_sorted [L, C, B] f32.
    """
    if _build.is_cpu(sorted_keys, sorted_frac, table):
        return span_gather_sorted_table_plain(sorted_keys, sorted_frac, table,
                                              spec, table_dtype)
    L, B = sorted_keys.shape
    D = spec.input_dim
    _, S, C = table.shape
    packed = _check_stream(sorted_keys, sorted_frac, D)
    req = _build.require
    req(table.dtype == torch.float32, "table must be float32")
    req(table_dtype in (torch.float32, torch.bfloat16),
        f"table_dtype must be float32 or bfloat16, got {table_dtype}")
    req(L == spec.num_levels and S == spec.table_size and C > 0,
        f"table shape {tuple(table.shape)} does not match the spec")
    req(S & (S - 1) == 0, f"table size {S} must be a power of two")
    req(all(t.is_contiguous() for t in (sorted_keys, sorted_frac, table)),
        "inputs must be contiguous")
    out = torch.empty((L, C, B), dtype=torch.float32, device=sorted_keys.device)
    _build.LAUNCHES["span_gather_sorted[table]"] += 1
    _build.launch("nvr_span_gather_table", sorted_keys.device,
                  sorted_keys.data_ptr(), sorted_frac.data_ptr(),
                  table.data_ptr(), _offsets_on(spec, table.device).data_ptr(),
                  out.data_ptr(), int(packed), int(table_dtype == torch.bfloat16),
                  L, D, C, B, S)
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
    hi = _pack_hi_on(frac.device)
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
    hi = _pack_hi_on(frac_t.device)[None, :, None]
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
# The work around the sort for packed positions (D = 3, C = 2): index,
# point-order gather, feature unpack, gradient transpose and permute
# ---------------------------------------------------------------------------

def encode_index_plain(spec: HashGridSpec, x01: torch.Tensor):
    """Plain version of :func:`encode_index`."""
    base_t, frac_t = base_and_frac_t(spec, x01)
    return base_t, pack_frac_t(frac_t)


def encode_index(spec: HashGridSpec, x01: torch.Tensor):
    """Base indices and packed in-cell positions of ``x01`` [B, 3] in [0,
    1]: ``base`` [L, B] int32 and ``pos`` [L, B] int32, bit-equal to
    :func:`base_and_frac_t` followed by :func:`pack_frac_t`.  One kernel
    (``csrc/encode_io.cu``), counted in ``LAUNCHES["encode_index"]``."""
    if _build.is_cpu(x01):
        return encode_index_plain(spec, x01)
    L, S = spec.num_levels, spec.table_size
    _build.require(spec.input_dim == 3 and x01.dim() == 2 and x01.shape[1] == 3,
                   f"encode_index takes [B, 3] points, got {tuple(x01.shape)}")
    x = x01.to(torch.float32).contiguous()
    B = x.shape[0]
    base = torch.empty((L, B), dtype=torch.int32, device=x.device)
    pos = torch.empty_like(base)
    _build.LAUNCHES["encode_index"] += 1
    _build.launch("nvr_encode_index", x.device, x.data_ptr(),
                  _scales_on(spec, x.device).data_ptr(),
                  _mult_on(spec, x.device).data_ptr(), base.data_ptr(),
                  pos.data_ptr(), L, B, S)
    return base, pos


def span_gather_point_order_plain(sorted_keys: torch.Tensor, perm: torch.Tensor,
                                  pos: torch.Tensor, table: torch.Tensor,
                                  spec: HashGridSpec, table_dtype=torch.float32):
    """Plain version of :func:`span_gather_point_order`: the positions
    gathered into sorted order, the table mode's plain version, and the
    features packed as bf16 pairs and put back in point order."""
    spf = torch.gather(pos, 1, perm)
    fs = span_gather_sorted_table_plain(sorted_keys, spf[:, None, :], table, spec,
                                        table_dtype)              # [L, 2, B]
    feats = torch.empty_like(pos)
    feats[torch.arange(perm.shape[0], device=pos.device)[:, None], perm] = _pack_feats(fs)
    return spf, feats


def span_gather_point_order(sorted_keys: torch.Tensor, perm: torch.Tensor,
                            pos: torch.Tensor, table: torch.Tensor,
                            spec: HashGridSpec, table_dtype=torch.float32):
    """The span gather's table mode reading and writing through the sort's
    permutation: for sorted slot ``(l, i)`` and ``p = perm[l, i]``, the
    packed position ``pos[l, p]`` goes to ``spf[l, i]`` and the features,
    as one bf16 pair (``_pack_feats``), to ``feats[l, p]``.  Bit-equal to
    gathering ``pos`` by ``perm``, :func:`span_gather_sorted_table`,
    ``_pack_feats`` and a scatter back to point order;
    :func:`unpack_feats_t` then makes the [B, L*2] f32 features.  Counted
    under ``LAUNCHES["span_gather_sorted[table,point_order]"]``.

    Args:
      sorted_keys: [L, B] int32, ascending per level, in [0, S).
      perm: [L, B] int64, the stable sort's permutation.
      pos: [L, B] int32 packed positions in point order (:func:`encode_index`).
      table: [L, S, 2] f32 canonical table.

    Returns:
      spf [L, B] int32 (``pos`` in sorted order) and feats [L, B] int32.
    """
    if _build.is_cpu(sorted_keys, perm, pos, table):
        return span_gather_point_order_plain(sorted_keys, perm, pos, table, spec,
                                             table_dtype)
    L, B = sorted_keys.shape
    _, S, C = table.shape
    req = _build.require
    req(sorted_keys.dtype == torch.int32 and pos.dtype == torch.int32
        and perm.dtype == torch.int64, "keys and pos must be int32, perm int64")
    req(tuple(perm.shape) == (L, B) and tuple(pos.shape) == (L, B),
        f"keys {tuple(sorted_keys.shape)}, perm {tuple(perm.shape)} and pos "
        f"{tuple(pos.shape)} disagree")
    req(table.dtype == torch.float32 and C == 2 and spec.input_dim == 3
        and L == spec.num_levels and S == spec.table_size,
        f"table shape {tuple(table.shape)} does not fit the packed route")
    req(table_dtype in (torch.float32, torch.bfloat16),
        f"table_dtype must be float32 or bfloat16, got {table_dtype}")
    req(all(t.is_contiguous() for t in (sorted_keys, perm, pos, table)),
        "inputs must be contiguous")
    spf = torch.empty_like(pos)
    feats = torch.empty_like(pos)
    _build.LAUNCHES["span_gather_sorted[table,point_order]"] += 1
    _build.launch("nvr_span_gather_point_order", pos.device,
                  sorted_keys.data_ptr(), pos.data_ptr(), perm.data_ptr(),
                  table.data_ptr(), _offsets_on(spec, table.device).data_ptr(),
                  spf.data_ptr(), feats.data_ptr(),
                  int(table_dtype == torch.bfloat16), L, B, S)
    return spf, feats


def unpack_feats_t_plain(feats: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`unpack_feats_t`."""
    L, B = feats.shape
    return _unpack_feats(feats.t()).reshape(B, L * 2)


def unpack_feats_t(feats: torch.Tensor) -> torch.Tensor:
    """Level-major ``_unpack_feats``: [L, B] int32 bf16 pairs -> [B, L*2]
    f32 features, a transpose and a widening in one kernel
    (``csrc/encode_io.cu``), counted in ``LAUNCHES["unpack_feats_t"]``."""
    if _build.is_cpu(feats):
        return unpack_feats_t_plain(feats)
    L, B = feats.shape
    _build.require(feats.dtype == torch.int32 and feats.is_contiguous() and L <= 32,
                   "feats must be contiguous [L, B] int32 with L <= 32")
    out = torch.empty((B, L * 2), dtype=torch.float32, device=feats.device)
    _build.LAUNCHES["unpack_feats_t"] += 1
    _build.launch("nvr_unpack_feats", feats.device, feats.data_ptr(), out.data_ptr(),
                  L, B)
    return out


def transpose_grad_t_plain(g: torch.Tensor, num_levels: int) -> torch.Tensor:
    """Plain version of :func:`transpose_grad_t`."""
    B = g.shape[0]
    return g.reshape(B, num_levels, 2).to(torch.float32).transpose(0, 1).contiguous()


def transpose_grad_t(g: torch.Tensor, num_levels: int) -> torch.Tensor:
    """The output gradient [B, L*2] in the level-major layout [L, B, 2]
    f32 (the inverse layout change of :func:`unpack_feats_t`): one kernel
    (``csrc/encode_io.cu``), counted in ``LAUNCHES["transpose_grad_t"]``."""
    if _build.is_cpu(g):
        return transpose_grad_t_plain(g, num_levels)
    L = int(num_levels)
    g = g.to(torch.float32).contiguous()
    B = g.shape[0]
    _build.require(g.dim() == 2 and g.shape[1] == L * 2 and L <= 32,
                   f"g must be [B, {L} * 2] with at most 32 levels, got {tuple(g.shape)}")
    gT = torch.empty((L, B, 2), dtype=torch.float32, device=g.device)
    _build.LAUNCHES["transpose_grad_t"] += 1
    _build.launch("nvr_transpose_grad", g.device, g.data_ptr(), gT.data_ptr(), L, B)
    return gT


def encode_grad_permute_plain(perm: torch.Tensor, spf: torch.Tensor,
                              gT: torch.Tensor):
    """Plain version of :func:`encode_grad_permute`."""
    L, B = perm.shape
    sg = torch.gather(gT, 1, perm[:, :, None].expand(L, B, 2))    # [L, B, 2]
    return sg.transpose(1, 2).contiguous(), unpack_frac_t(spf)


def encode_grad_permute(perm: torch.Tensor, spf: torch.Tensor, gT: torch.Tensor):
    """The level-major output gradient ``gT`` [L, B, 2]
    (:func:`transpose_grad_t`) and the packed sorted positions ``spf`` [L,
    B] in the layout the bucket kernel takes: ``sg[l, c, i] = gT[l, perm[l,
    i], c]`` [L, 2, B] and ``sf`` = :func:`unpack_frac_t` of ``spf`` [L, 3,
    B], both f32.  One kernel (``csrc/encode_io.cu``), counted in
    ``LAUNCHES["encode_grad_permute"]``."""
    if _build.is_cpu(perm, spf, gT):
        return encode_grad_permute_plain(perm, spf, gT)
    L, B = perm.shape
    req = _build.require
    req(perm.dtype == torch.int64 and spf.dtype == torch.int32
        and gT.dtype == torch.float32, "perm must be int64, spf int32 and gT float32")
    req(tuple(spf.shape) == (L, B) and tuple(gT.shape) == (L, B, 2),
        f"perm {tuple(perm.shape)}, spf {tuple(spf.shape)} and gT "
        f"{tuple(gT.shape)} disagree")
    req(all(t.is_contiguous() for t in (perm, spf, gT)), "inputs must be contiguous")
    sg = torch.empty((L, 2, B), dtype=torch.float32, device=gT.device)
    sf = torch.empty((L, 3, B), dtype=torch.float32, device=gT.device)
    _build.LAUNCHES["encode_grad_permute"] += 1
    _build.launch("nvr_encode_grad_permute", gT.device, perm.data_ptr(),
                  spf.data_ptr(), gT.data_ptr(), sg.data_ptr(), sf.data_ptr(), L, B)
    return sg, sf


# ---------------------------------------------------------------------------
# Full sorted-forward encode with the bucket backward
# ---------------------------------------------------------------------------

def _encode_sorted(base_t, pos, gather, n_channels: int):
    """Point-order features [B, L*C] plus what the backward reuses: the
    sorted keys, the permutation and the sorted positions (``pos`` packed
    by :func:`pack_frac_t`, int32 [L, B], or f32 [L, D, B]), gathered and
    scattered with PyTorch ops.  Its callers: :func:`sorted_encode` for f32
    positions, and :func:`sorted_encode_features`.
    ``gather(sorted_keys, sorted_frac)`` is the span gather of one table
    layout.  Layer ranges ``encode.sort``, ``encode.permute`` (positions to
    sorted order), ``encode.gather``, ``encode.permute`` (features back to
    point order)."""
    L, B = base_t.shape
    C = int(n_channels)
    with layer_range("encode.sort"):
        sk, perm = torch.sort(base_t, dim=-1, stable=True)       # int32, int64
    if pos.dtype == torch.int32:
        with layer_range("encode.permute"):
            spf = torch.gather(pos, 1, perm)                      # [L, B] int32
        with layer_range("encode.gather"):
            feats_sorted = gather(sk, spf[:, None, :])           # [L, C, B]
        with layer_range("encode.permute"):
            packed_sorted = _pack_feats(feats_sorted)            # [L, B]
            packed = torch.empty_like(packed_sorted).scatter_(1, perm, packed_sorted)
            out = _unpack_feats(packed.t())                      # [B, L, 2]
            return out.reshape(B, L * C), (sk, perm, spf)
    D = pos.shape[1]
    with layer_range("encode.permute"):
        sfr = torch.gather(pos, 2, perm[:, None, :].expand(L, D, B))
    with layer_range("encode.gather"):
        feats_sorted = gather(sk, sfr)
    with layer_range("encode.permute"):
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
    D = int(input_dim)
    C = rolled_fm.shape[1] >> D

    def gather(sk, sfrac):
        return span_gather_sorted(sk, sfrac, rolled_fm, input_dim=D)

    with layer_range("encode.index"):
        pos = pack_frac_t(frac_t) if pack and D == 3 and C == 2 else frac_t
    return _encode_sorted(base_t, pos, gather, C)[0]


class _SortedEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x01, table, spec, table_dtype, pack):
        shape = (*x01.shape[:-1], spec.output_dim)
        pack = bool(pack) and spec.input_dim == 3 and spec.level_dim == 2
        with layer_range("encode.index"):
            tab = table.detach()
            x = x01.detach().reshape(-1, spec.input_dim)
            if pack:
                base_t, pos = encode_index(spec, x)
            else:
                base_t, frac_t = base_and_frac_t(spec, x)
        if pack:
            with layer_range("encode.sort"):
                sk, perm = torch.sort(base_t, dim=-1, stable=True)
            del base_t
            with layer_range("encode.gather"):
                sfrac, feats = span_gather_point_order(sk, perm, pos, tab, spec,
                                                       table_dtype)
            del pos
            with layer_range("encode.permute"):
                out = unpack_feats_t(feats).reshape(shape)
        else:
            def gather(sk, sfrac):
                return span_gather_sorted_table(sk, sfrac, tab, spec, table_dtype)

            out, (sk, perm, sfrac) = _encode_sorted(base_t, frac_t, gather,
                                                    table.shape[2])
            with layer_range("encode.permute"):
                out = out.reshape(shape)
        ctx.save_for_backward(sk, perm, sfrac)
        ctx.spec = spec
        ctx.pack = pack
        ctx.n_channels = table.shape[2]
        return out

    @staticmethod
    def backward(ctx, g):
        range_mark("backward.encode.permute")
        sk, perm, sfrac = ctx.saved_tensors
        spec = ctx.spec
        L, B = sk.shape
        C = ctx.n_channels
        if ctx.pack:
            gT = transpose_grad_t(g.reshape(B, L * C), L)
            sg, sf = encode_grad_permute(perm, sfrac, gT)
            del gT
        else:
            sf = sfrac
            gt = g.reshape(B, L, C).permute(1, 2, 0).to(torch.float32)  # [L, C, B]
            sg = torch.gather(gt, 2, perm[:, None, :].expand(L, C, B))
        range_mark("backward.encode.bucket")
        grad_rolled = bucket_grad_matmul(
            sk, sf, sg, table_size=spec.table_size, input_dim=spec.input_dim,
            extend_cols=_PAD)                                    # [L, K*C, S+pad]
        range_mark("backward.encode.unroll")
        grad_table = unroll_reduce_fm(grad_rolled, spec, C)      # [L, S, C]
        return None, grad_table, None, None, None


def sorted_encode(x01: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                  table_dtype=torch.float32, pack: bool = True) -> torch.Tensor:
    """Coherent hash encode, sorted span-gather forward: [..., D] -> [..., L*C].

    Differentiable wrt ``table`` only (bucket + unroll backward).  Raises
    if ``x01`` requires grad: this path computes no position gradients
    (the JAX package returns zeros for them silently).
    """
    if torch.is_grad_enabled() and x01.requires_grad:
        raise NotImplementedError(
            "sorted_encode gives no gradient wrt positions; set the encoder's "
            "input_grads: True to take the coherent_encode path, which does")
    return _SortedEncode.apply(x01, table, spec, table_dtype, pack)
