"""Host data engine (C++, through ctypes) with NumPy paths beside it.

The port's copy of the JAX package's ``native/``: the host-side hot loops
of dataset ingestion, run once at load.

- ``ptycho_mask_batch``: beam masks for all views
- ``build_pools``: static-shaped valid-pixel index pools

The library is built on first use (``build.py``).  Where it cannot be
built or loaded (no g++), the public functions run their NumPy paths,
which give the same bits; ``available()`` says whether the C++ path is
active and ``load_error()`` why it is not.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..metrics import get_ptycho_mask

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error, _tried
    if _tried:
        return _lib
    _tried = True
    from .build import build

    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        _error = str(e)
        return None
    i64, i32p, f32p, u8p = (
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    )
    lib.nvr_ptycho_mask_batch.argtypes = [f32p, i64, i64, i64, ctypes.c_float, u8p]
    lib.nvr_ptycho_mask_batch.restype = None
    lib.nvr_pool_counts_max.argtypes = [f32p, i64, i64, i32p]
    lib.nvr_pool_counts_max.restype = ctypes.c_int32
    lib.nvr_fill_pools.argtypes = [f32p, i64, i64, i64, i32p, i32p]
    lib.nvr_fill_pools.restype = None
    lib.nvr_version.argtypes = []
    lib.nvr_version.restype = ctypes.c_int32
    if lib.nvr_version() != 1:
        raise RuntimeError(f"data engine version {lib.nvr_version()}, expected 1")
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the C++ library is built and loaded."""
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the C++ library is not in use (None when it is)."""
    _load()
    return _error


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def ptycho_mask_batch(full_proj: np.ndarray, threshold: float = 0.007
                      ) -> np.ndarray:
    """Beam masks [N, H, W] float32 (1 = keep) from (complex) projections,
    ``metrics.get_ptycho_mask`` per view."""
    fp = np.asarray(full_proj)
    if fp.ndim == 2:
        fp = fp[None]
    mag = np.ascontiguousarray(np.abs(fp), np.float32)
    lib = _load()
    if lib is None:
        return _ptycho_mask_batch_numpy(mag, threshold)
    n, h, w = mag.shape
    out = np.empty((n, h, w), np.uint8)
    lib.nvr_ptycho_mask_batch(_f32p(mag), n, h, w, ctypes.c_float(threshold),
                              _u8p(out))
    return out.astype(np.float32)


def _ptycho_mask_batch_numpy(mag: np.ndarray, threshold: float) -> np.ndarray:
    return np.stack([get_ptycho_mask(m, threshold).astype(np.float32)
                     for m in mag])


def build_pools(projs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-view valid-pixel pools (|proj| > 0) padded by cyclic repetition.

    Returns (pools [N, P] int32, counts [N] int32); all-invalid views fall
    back to the full pixel set.
    """
    p = np.ascontiguousarray(np.asarray(projs, np.float32))
    lib = _load()
    if lib is None:
        return _build_pools_numpy(p)
    n, h, w = p.shape
    hw = h * w
    counts = np.empty((n,), np.int32)
    mx = int(lib.nvr_pool_counts_max(_f32p(p), n, hw, _i32p(counts)))
    # all-invalid views fall back to the full pixel set, so the padded
    # pool length becomes hw (as in _build_pools_numpy)
    pool_len = hw if (counts == 0).any() else max(mx, 1)
    pools = np.empty((n, pool_len), np.int32)
    lib.nvr_fill_pools(_f32p(p), n, hw, pool_len, _i32p(pools), _i32p(counts))
    return pools, counts


def _build_pools_numpy(projs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    n = projs.shape[0]
    flat = np.abs(projs.reshape(n, -1)) > 0
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
