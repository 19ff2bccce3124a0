"""Corner-roll kernels: canonical <-> feature-major rolled tables.

Port of the JAX ``ops/roll_kernels.py``.  The JAX sorted span-gather
forward reads the rolled feature-major table
``R[l, k*C+c, s] = T[l, (s+off[l,k]) % S, c]`` and the bucket backward
emits its gradient in the same layout; converting between the two is pure
data movement -- K shifted copies (build) and a K-way shifted sum
(gradient).  In the port the build serves the rolled encoder path
(``coherent_hash.coherent_encode``) and ``sorted_encode_features``; the
sorted main path gathers from the canonical table in place
(``span_gather.span_gather_sorted_table``).

For CUDA tensors the wrappers launch the kernels of
``csrc/roll_kernels.cu``; for CPU tensors they run the plain PyTorch
versions beside them (per-(level, corner) ``torch.roll``).
"""

from __future__ import annotations

import torch

from . import _build
from .coherent_hash import _offsets_on, corner_offsets
from .hash_encoding import HashGridSpec

# Width of the wrapped copy that the bucket backward appends to the rolled
# gradient (JAX: ``_BLK + 128``).  Kept for parity of shapes; the CUDA
# unroll kernel takes columns mod S and never reads the copy.
_PAD = 4096 + 128


def wrap_extend(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Append a circularly-wrapped copy of ``x``'s first ``pad`` columns
    (tiling if ``pad`` exceeds the column count)."""
    S = x.shape[-1]
    parts = [x]
    left = pad
    while left > 0:
        take = min(left, S)
        parts.append(x[..., :take])
        left -= take
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def roll_broadcast_fm_plain(table: torch.Tensor, spec: HashGridSpec,
                            dtype=torch.float32) -> torch.Tensor:
    """Plain version of :func:`roll_broadcast_fm`: one ``torch.roll`` per
    (level, corner)."""
    L, S, C = table.shape
    K = 1 << spec.input_dim
    offs = corner_offsets(spec)
    tfm = table.transpose(1, 2).to(dtype)                        # [L, C, S]
    rows = [torch.stack([torch.roll(tfm[l], -int(offs[l, k]), dims=-1)
                         for l in range(L)])                     # [L, C, S]
            for k in range(K)]
    return torch.cat(rows, dim=1)                                # [L, K*C, S]


def unroll_reduce_fm_plain(grad_ext: torch.Tensor, spec: HashGridSpec,
                           n_channels: int) -> torch.Tensor:
    """Plain version of :func:`unroll_reduce_fm`: a sum of rolls over the
    first ``S = Se - _PAD`` columns, in corner order."""
    L, F, Se = grad_ext.shape
    return _unroll_sum(grad_ext[:, :, : Se - _PAD], spec, n_channels)


def _unroll_sum(grad: torch.Tensor, spec: HashGridSpec, C: int) -> torch.Tensor:
    """[L, K*C, S] -> [L, S, C], ``sum_k grad[l, k*C+c, (j - off) % S]``."""
    L = grad.shape[0]
    K = grad.shape[1] // C
    offs = corner_offsets(spec)
    acc = None
    for k in range(K):
        part = torch.stack([torch.roll(grad[l, k * C:(k + 1) * C],
                                       int(offs[l, k]), dims=-1)
                            for l in range(L)]).to(torch.float32)  # [L, C, S]
        acc = part if acc is None else acc + part
    return acc.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def roll_broadcast_fm(table: torch.Tensor, spec: HashGridSpec,
                      dtype=torch.float32) -> torch.Tensor:
    """Canonical [L, S, C] f32 -> feature-major rolled [L, K*C, S] ``dtype``.

    ``R[l, k*C+c, s] = table[l, (s + off[l,k]) % S, c]``.
    """
    if _build.is_cpu(table):
        return roll_broadcast_fm_plain(table, spec, dtype)
    L, S, C = table.shape
    K = 1 << spec.input_dim
    _build.require(table.dtype == torch.float32, "table must be float32")
    _build.require(table.is_contiguous(), "table must be contiguous")
    _build.require(L == spec.num_levels and S == spec.table_size,
                   f"table shape {tuple(table.shape)} does not match the spec")
    _build.require(dtype in (torch.float32, torch.bfloat16),
                   f"dtype must be float32 or bfloat16, got {dtype}")
    out = torch.empty((L, K * C, S), dtype=dtype, device=table.device)
    _build.LAUNCHES["roll_broadcast_fm"] += 1
    _build.launch("nvr_roll_broadcast_fm", table.device, table.data_ptr(),
                  _offsets_on(spec, table.device).data_ptr(), out.data_ptr(),
                  int(dtype == torch.bfloat16), L, K, C, S)
    return out


def unroll_reduce_fm(grad_ext: torch.Tensor, spec: HashGridSpec,
                     n_channels: int) -> torch.Tensor:
    """Rolled-fm gradient -> canonical [L, S, C] f32.

    ``out[l, j, c] = sum_k grad[l, k*C+c, (j - off[l,k]) % S]``.

    Args:
      grad_ext: [L, K*C, S + _PAD] f32 or bf16 -- the rolled gradient
        extended with its own first ``_PAD`` columns, as
        ``bucket_grad_matmul(..., extend_cols=_PAD)`` emits it.  bf16 is
        widened to f32 value by value; the sum is f32 either way.
    """
    if _build.is_cpu(grad_ext):
        return unroll_reduce_fm_plain(grad_ext, spec, n_channels)
    L, F, Se = grad_ext.shape
    C = int(n_channels)
    K = F // C
    S = Se - _PAD
    _build.require(grad_ext.dtype in (torch.float32, torch.bfloat16),
                   f"grad must be float32 or bfloat16, got {grad_ext.dtype}")
    _build.require(grad_ext.is_contiguous(), "grad must be contiguous")
    _build.require(K == 1 << spec.input_dim and K * C == F
                   and L == spec.num_levels and S == spec.table_size,
                   f"grad shape {tuple(grad_ext.shape)} does not match the spec")
    out = torch.empty((L, S, C), dtype=torch.float32, device=grad_ext.device)
    _build.LAUNCHES["unroll_reduce_fm"] += 1
    _build.launch("nvr_unroll_reduce_fm", grad_ext.device, grad_ext.data_ptr(),
                  _offsets_on(spec, grad_ext.device).data_ptr(), out.data_ptr(),
                  int(grad_ext.dtype == torch.bfloat16), L, K, C, S, Se)
    return out
