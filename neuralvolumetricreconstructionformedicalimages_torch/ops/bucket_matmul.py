"""Deterministic segment accumulation of sorted hash-grid updates.

Port of the JAX ``ops/bucket_matmul.py``: the hash-encoder backward sorts
its updates by table index and reduces every index's run into the rolled
feature-major gradient ``g[l, k*C+c, s] = sum_{m: key_m=s} w_k * grad[l,c,m]``
-- a scatter-add without scatter collisions, in a fixed order, so the
result is bitwise reproducible.

For CUDA tensors :func:`bucket_grad_matmul` launches the kernel of
``csrc/bucket_matmul.cu``; for CPU tensors it runs the plain version
beside it, a scatter-add of the k-major payload taken in stream order.
The kernel is bound by the bytes it writes (the table-shaped gradient,
almost all of it zeros on the main path) and by its longest run, a chain
of dependent adds.  One block takes a tile of 1024 columns of one level:
it finds the tile's segment of the sorted stream with two searches and
each run's start by searching the segment in shared memory; a thread
sums each short run and stores every row of its columns, zeros included,
with neighbouring threads on neighbouring columns.  Longer runs go to
warps that stage them with coalesced loads, and runs of 2048 or more to
extra blocks, so that the dense coarse levels spread over many SMs.  The
summation order is unchanged from the first design (one thread per
column): each sum over its run in stream order, so the kernel equals the
plain version bit for bit.

The order matters: a long run (coarse levels hold thousands of points
per column) summed in another order differs in f32 by ~1e-4; an atomic
scatter on the card does exactly that.  The plain version therefore adds
the r-th element of every run in its r-th pass, so each column is summed
in stream order, as the kernel sums it, and the two agree bit for bit.
"""

from __future__ import annotations

import torch

from . import _build
from .coherent_hash import corner_bits


def _payload(frac: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """k-major payload ``pay[l, k*C+c, m] = w_k(frac[l,:,m]) * grads[l,c,m]``
    with ``w_k = prod_d (bit ? f_d : 1 - f_d)`` taken in d order."""
    L, D, B = frac.shape
    K = 1 << D
    C = grads.shape[1]
    bits = corner_bits(D)
    rows = []
    for k in range(K):
        wk = torch.ones((L, B), dtype=torch.float32, device=frac.device)
        for d in range(D):
            t = frac[:, d]
            wk = wk * (t if bits[k, d] else 1.0 - t)
        rows.append(wk)
    w = torch.stack(rows, dim=1)                                  # [L, K, B]
    return (w[:, :, None, :] * grads[:, None, :, :]).reshape(L, K * C, B)


def bucket_grad_matmul_plain(
    sorted_keys: torch.Tensor,
    sorted_frac: torch.Tensor,
    sorted_grads: torch.Tensor,
    *,
    table_size: int,
    input_dim: int,
    out_dtype=torch.float32,
    extend_cols: int = 0,
) -> torch.Tensor:
    """Plain version of :func:`bucket_grad_matmul`: a scatter-add of the
    k-major payload, each column summed in stream order (keys need not be
    sorted: a stable sort puts each run in stream order first)."""
    L, B = sorted_keys.shape
    S = int(table_size)
    D = int(input_dim)
    dev = sorted_keys.device
    frac = sorted_frac.to(torch.float32).reshape(L, D, B)
    pay = _payload(frac, sorted_grads.to(torch.float32))          # [L, F, B]
    F = pay.shape[1]
    col = (sorted_keys.long() + torch.arange(L, device=dev)[:, None] * S).reshape(-1)
    col, perm = torch.sort(col, stable=True)        # identity for sorted keys
    pay = pay.permute(0, 2, 1).reshape(L * B, F)[perm]
    # rank of every element within its run of equal columns
    idx = torch.arange(col.numel(), device=dev)
    new_run = torch.ones_like(col, dtype=torch.bool)
    new_run[1:] = col[1:] != col[:-1]
    rank = idx - torch.cummax(torch.where(new_run, idx, 0), 0).values
    by_rank = torch.sort(rank, stable=True).indices
    out = torch.zeros((L * S, F), dtype=torch.float32, device=dev)
    start = 0
    for n in torch.bincount(rank).tolist():   # pass r: one element per run
        sel = by_rank[start:start + n]
        out[col[sel]] += pay[sel]
        start += n
    out = out.reshape(L, S, F).permute(0, 2, 1).contiguous()
    if extend_cols:
        from .roll_kernels import wrap_extend

        out = wrap_extend(out, extend_cols)
    return out.to(out_dtype)


def bucket_grad_matmul(
    sorted_keys: torch.Tensor,
    sorted_frac: torch.Tensor,
    sorted_grads: torch.Tensor,
    *,
    table_size: int,
    input_dim: int,
    out_dtype=torch.float32,
    extend_cols: int = 0,
) -> torch.Tensor:
    """Segment-sum sorted hash-grid updates into per-level gradient tables.

    Args:
      sorted_keys: [L, B] int32, ascending per level, in [0, table_size).
      sorted_frac: [L, D, B] f32 in-cell fractional positions (sorted
        order); with ``input_dim=0`` an empty [L, 0, B] (weight 1).
      sorted_grads: [L, C, B] f32 output gradients (sorted order).
      table_size: per-level table length S.
      input_dim: D (0, 2 or 3).
      out_dtype: float32 or bfloat16 (accumulation is f32 either way).
      extend_cols: append a wrapped copy of the first ``extend_cols``
        columns (for the unroll reduce).

    Returns:
      grad_rolled [L, K*C, S + extend_cols] ``out_dtype``, K = 2^D.
    """
    if _build.is_cpu(sorted_keys, sorted_frac, sorted_grads):
        return bucket_grad_matmul_plain(
            sorted_keys, sorted_frac, sorted_grads, table_size=table_size,
            input_dim=input_dim, out_dtype=out_dtype, extend_cols=extend_cols)
    L, B = sorted_keys.shape
    S, D, E = int(table_size), int(input_dim), int(extend_cols)
    C = sorted_grads.shape[1]
    K = 1 << D
    req = _build.require
    req(sorted_keys.dtype == torch.int32, "sorted_keys must be int32")
    req(sorted_frac.dtype == torch.float32 and sorted_grads.dtype == torch.float32,
        "sorted_frac and sorted_grads must be float32")
    req(D in (0, 2, 3), f"input_dim must be 0, 2 or 3, got {D}")
    req(C in (1, 2, 4, 8), f"channel count must be 1, 2, 4 or 8, got {C}")
    req(tuple(sorted_frac.shape) == (L, D, B)
        and tuple(sorted_grads.shape) == (L, C, B),
        f"shapes keys {tuple(sorted_keys.shape)}, frac "
        f"{tuple(sorted_frac.shape)}, grads {tuple(sorted_grads.shape)} disagree")
    req(all(t.is_contiguous() for t in (sorted_keys, sorted_frac, sorted_grads)),
        "inputs must be contiguous")
    req(out_dtype in (torch.float32, torch.bfloat16),
        f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    req(S > 0 and E >= 0, "table_size must be > 0 and extend_cols >= 0")
    out = torch.empty((L, K * C, S + E), dtype=out_dtype,
                      device=sorted_keys.device)
    _build.LAUNCHES["bucket_grad_matmul"] += 1
    _build.launch("nvr_bucket_grad_matmul", sorted_keys.device,
                  sorted_keys.data_ptr(), sorted_frac.data_ptr(),
                  sorted_grads.data_ptr(), out.data_ptr(),
                  int(out_dtype == torch.bfloat16), L, D, C, B, S, E)
    return out


def bucket_grad_matmul_reference(
    keys: torch.Tensor,
    frac: torch.Tensor,
    grads: torch.Tensor,
    *,
    table_size: int,
    input_dim: int,
) -> torch.Tensor:
    """Exact oracle (plain scatter-add, f32); keys need not be sorted."""
    return bucket_grad_matmul_plain(keys, frac, grads, table_size=table_size,
                                    input_dim=input_dim)
