"""Multiresolution hash-grid configuration (Instant-NGP style).

Port of the JAX ``ops/hash_encoding.py::HashGridSpec``: per-level scale
``2^l * H - 1``, resolution ``ceil(scale) + 1``, per-level live size
``min(2^S, (res+1)^D)`` and the uniformly padded ``[L, 2^S, C]`` table
initialised U(-1e-4, 1e-4).  The XOR-hash encoders of that module are not
ported yet (ROADMAP.md, Queue 1 item 1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch


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
