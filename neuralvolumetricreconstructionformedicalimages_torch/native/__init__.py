"""Host-side data helpers: beam masks and valid-pixel pools (NumPy).

The port's own copies of the NumPy paths of the JAX package's
``native/__init__.py``.  The C++ host engine behind them there is not
ported yet (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..metrics import get_ptycho_mask


def ptycho_mask_batch(full_proj: np.ndarray, threshold: float = 0.007
                      ) -> np.ndarray:
    """Beam masks [N, H, W] float32 (1 = keep) from (complex) projections,
    ``metrics.get_ptycho_mask`` per view."""
    fp = np.asarray(full_proj)
    if fp.ndim == 2:
        fp = fp[None]
    mag = np.ascontiguousarray(np.abs(fp), np.float32)
    return np.stack([get_ptycho_mask(m, threshold).astype(np.float32)
                     for m in mag])


def build_pools(projs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-view valid-pixel pools (|proj| > 0) padded by cyclic repetition.

    Returns (pools [N, P] int32, counts [N] int32); all-invalid views fall
    back to the full pixel set.
    """
    p = np.asarray(projs, np.float32)
    n = p.shape[0]
    flat = np.abs(p.reshape(n, -1)) > 0
    counts = flat.sum(axis=1)
    if (counts == 0).any():
        flat[counts == 0] = True
        counts = flat.sum(axis=1)
    pool_len = int(counts.max())
    pools = np.zeros((n, pool_len), np.int32)
    for i in range(n):
        idx = np.flatnonzero(flat[i]).astype(np.int32)
        reps = int(np.ceil(pool_len / idx.size))
        pools[i] = np.tile(idx, reps)[:pool_len]
    return pools, counts.astype(np.int32)
