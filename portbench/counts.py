"""The yardstick's arithmetic: the card's peaks and the operations and
bytes that a training step's work needs, counted from the configuration's
widths and the step's inputs, whatever implements the step.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense):
67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

PEAKS = {"f32_flop_per_s": 67e12, "hbm_byte_per_s": 3.35e12}

# Adam's operations a parameter: m = b1 m + (1 - b1) g (3), v = b2 v +
# (1 - b2) g^2 (4), sqrt(v / c2) + eps (3), p -= lr (m / c1) / denom (3).
ADAM_FLOP_PER_PARAM = 13


def mlp_flop_per_point(dims: List[Tuple[int, int]]) -> int:
    """The MLP's products a point, forward (x W^T) and backward (the
    input's gradient, which the table's gradient needs, and the weight's):
    3 GEMMs of 2 * fan_in * fan_out operations each layer."""
    return 3 * sum(2 * i * o for i, o in dims)


def encoder_flop_per_point_level(channels: int, dim: int = 3) -> int:
    """The trilinear interpolation a point a level: the 2^D corner weights
    (D - 1 products each, after D subtractions 1 - f), their weighted sum
    of C channels (2 operations a corner a channel), and the gradient's
    weighted sum into the corner rows (the same again)."""
    corners = 1 << dim
    forward = corners * (dim - 1) + dim + 2 * corners * channels
    backward = 2 * corners * channels
    return forward + backward


def step_flop(points: int, dims: List[Tuple[int, int]], levels: int,
              channels: int, n_params: int) -> float:
    """Operations a training step's model math needs: the MLP's products
    forward and backward, the encoder's interpolation and its gradient,
    and Adam over every parameter."""
    return float(points * mlp_flop_per_point(dims)
                 + points * levels * encoder_flop_per_point_level(channels)
                 + n_params * ADAM_FLOP_PER_PARAM)


def hash_encoder_work(points: int, levels: int, table_rows: int, channels: int,
                      distinct_rows: float) -> Dict[str, float]:
    """Bytes and operations of the encoder's work a step, each byte read
    once and written once.  Forward: each point's key and packed in-cell
    position a level (4 + 4 bytes), each distinct table row the step's
    points touch (C f32), the features written (C f32 a point a level).
    Backward: the features' gradient read (C f32 a point a level) and the
    dense table gradient written (L x 2^T x C f32)."""
    pl = points * levels
    nbytes = (8.0 * pl + 4.0 * channels * distinct_rows + 4.0 * channels * pl
              + 4.0 * channels * pl + 4.0 * channels * levels * table_rows)
    return {"bytes": nbytes,
            "flop": float(pl * encoder_flop_per_point_level(channels))}


def least_seconds(work: Dict[str, float]) -> float:
    """The least time the card could take: the larger of bytes over the
    HBM bandwidth and operations over the f32 peak."""
    return max(work["bytes"] / PEAKS["hbm_byte_per_s"],
               work["flop"] / PEAKS["f32_flop_per_s"])


def distinct_rows(rows: torch.Tensor) -> int:
    """The number of distinct table rows among flat corner rows [P, L, 8]
    (each level's rows already offset into the flat table)."""
    return int(torch.unique(rows.reshape(-1)).numel())
