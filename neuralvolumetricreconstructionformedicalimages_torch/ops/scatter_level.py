"""Direct scatter-add of one hash-grid level's updates (the encoder
microbenchmark's serial-scatter strategy).

Port of ``scripts/microbench_encoder.py::pallas_scatter_level``:
``out[j, :] = sum_{i: idx[i] = j} payload[i, :]`` into a fresh [S, C]
table.  For CUDA tensors :func:`scatter_level` launches the kernel of
``csrc/scatter_level.cu`` (zero fill, then one vector ``atomicAdd`` per
update); for CPU tensors it runs :func:`scatter_level_plain`
(``index_add_``).

The atomics sum each column in no fixed order, so the kernel equals the
plain version to rtol/atol 1e-5 on normal payloads and bit for bit on
integer-valued ones.
"""

from __future__ import annotations

import torch

from . import _build


def scatter_level_plain(idx: torch.Tensor, payload: torch.Tensor,
                        table_size: int) -> torch.Tensor:
    """Plain version of :func:`scatter_level`: ``index_add_`` into zeros."""
    S, C = int(table_size), payload.shape[1]
    out = torch.zeros((S, C), dtype=torch.float32, device=payload.device)
    return out.index_add_(0, idx.long(), payload.to(torch.float32))


def scatter_level(idx: torch.Tensor, payload: torch.Tensor,
                  table_size: int) -> torch.Tensor:
    """Scatter-add ``payload`` rows into a zero [S, C] f32 table.

    Args:
      idx: [N] int32 row of every update, in [0, table_size).
      payload: [N, C] f32, C in {1, 2, 4}.
      table_size: S.
    """
    if _build.is_cpu(idx, payload):
        return scatter_level_plain(idx, payload, table_size)
    S = int(table_size)
    req = _build.require
    req(idx.dtype == torch.int32, "idx must be int32")
    req(payload.dtype == torch.float32, "payload must be float32")
    req(idx.dim() == 1 and payload.dim() == 2
        and payload.shape[0] == idx.shape[0],
        f"shapes idx {tuple(idx.shape)} and payload {tuple(payload.shape)} "
        f"disagree")
    C = payload.shape[1]
    req(C in (1, 2, 4), f"channel count must be 1, 2 or 4, got {C}")
    req(idx.is_contiguous() and payload.is_contiguous(),
        "inputs must be contiguous")
    req(payload.data_ptr() % (4 * C) == 0,
        "payload rows must be aligned to their width")
    req(S > 0, "table_size must be > 0")
    out = torch.empty((S, C), dtype=torch.float32, device=idx.device)
    _build.LAUNCHES["scatter_level"] += 1
    _build.launch("nvr_scatter_level", idx.device, idx.data_ptr(),
                  payload.data_ptr(), out.data_ptr(), C, idx.shape[0], S)
    return out
