"""In-order scatter-add of one hash-grid level's updates (the encoder
microbenchmark's serial-scatter strategy).

Port of ``scripts/microbench_encoder.py::pallas_scatter_level``: each row
``j`` of a fresh [S, C] f32 table is ``0 + payload[i0] + payload[i1] + ...``
over the updates with ``idx[i] = j``, added one at a time in ascending
``i``, as the TPU kernel's serial loop adds them.  For CUDA tensors
:func:`scatter_level` launches the kernels of ``csrc/scatter_level.cu`` (a
stable partition of the updates by slab of rows, then one block a slab
adding them in update order in shared memory; no atomics on device memory,
no zero fill); for CPU tensors it runs :func:`scatter_level_plain`.  Both
equal ``np.add.at`` bit for bit on any payload.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build

# The kernel's sizes (csrc/scatter_level.cu): updates a partition block
# takes (kTile), f32 accumulators a block holds (kSlabFloats), and the
# most slabs a partition block counts (kMaxSlabs).
TILE = 4096
SLAB_FLOATS = 4096
MAX_SLABS = 2048


class ScatterPlan(NamedTuple):
    rows: int        # rows a block accumulates in shared memory
    windows: int     # blocks a slab takes (a power of two)
    n_slabs: int     # slabs of rows * windows rows
    n_tiles: int     # partition blocks
    word_bytes: int  # an update's staged word: row within its slab and
                     # place in its tile, 16 bits each, or 32 past 2^16 rows
    ws_bytes: int    # workspace: staged words, slab offsets


@functools.lru_cache(maxsize=64)
def scatter_plan(N: int, S: int, C: int) -> ScatterPlan:
    """The sizes of the kernel's launch and workspace for N updates into
    an [S, C] table, as ``csrc/scatter_level.cu::make_plan`` computes them
    (the kernel refuses a smaller workspace)."""
    rows = SLAB_FLOATS // C
    windows = 1
    while -(-S // (rows * windows)) > MAX_SLABS:
        windows *= 2
    n_slabs = -(-S // (rows * windows))
    n_tiles = -(-N // TILE)
    word_bytes = 4 if rows * windows <= 1 << 16 else 8
    return ScatterPlan(rows, windows, n_slabs, n_tiles, word_bytes,
                       N * word_bytes + (n_slabs + 1) * n_tiles * 4)


def scatter_level_plain(idx: torch.Tensor, payload: torch.Tensor,
                        table_size: int) -> torch.Tensor:
    """Plain version of :func:`scatter_level`: ``index_add_`` into zeros.

    On the CPU ``index_add_`` adds in update order, bit-equal to
    ``np.add.at``.  On a CUDA tensor it adds with atomics, in no fixed
    order: hold the kernel against this function on a CPU copy."""
    S, C = int(table_size), payload.shape[1]
    out = torch.zeros((S, C), dtype=torch.float32, device=payload.device)
    return out.index_add_(0, idx.long(), payload.to(torch.float32))


def scatter_level(idx: torch.Tensor, payload: torch.Tensor,
                  table_size: int) -> torch.Tensor:
    """Scatter-add ``payload`` rows into a zero [S, C] f32 table, each row's
    updates in their order in the stream.

    Args:
      idx: [N] int32 row of every update; one outside [0, table_size) is
        skipped.
      payload: [N, C] f32, C in {1, 2, 4}.
      table_size: S.
    """
    if _build.is_cpu(idx, payload):
        return scatter_level_plain(idx, payload, table_size)
    S = int(table_size)
    # one test on the launch path; the messages are built only on failure
    C = payload.shape[1] if payload.dim() == 2 else 0
    if not (idx.dtype == torch.int32 and payload.dtype == torch.float32
            and idx.dim() == 1 and C in (1, 2, 4)
            and payload.shape[0] == idx.shape[0] and S > 0
            and idx.is_contiguous() and payload.is_contiguous()
            and payload.data_ptr() % (4 * C) == 0):
        _refuse(idx, payload, S)
    N = idx.shape[0]
    plan = scatter_plan(N, S, C)
    out = idx.new_empty((S, C), dtype=torch.float32)
    ws = idx.new_empty(plan.ws_bytes, dtype=torch.uint8)
    _build.LAUNCHES["scatter_level"] += 1
    _build.launch("nvr_scatter_level", idx.device, idx.data_ptr(),
                  payload.data_ptr(), out.data_ptr(), ws.data_ptr(), C, N, S,
                  plan.ws_bytes)
    return out


def _refuse(idx: torch.Tensor, payload: torch.Tensor, S: int) -> None:
    """Raise the ``ValueError`` that names what :func:`scatter_level`
    refuses."""
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
    raise ValueError("scatter_level: arguments refused")
