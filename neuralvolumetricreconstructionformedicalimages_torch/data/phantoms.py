"""Analytic 3D phantoms for synthetic datasets, tests, and benchmarks.

Port of the JAX package's ``data/phantoms.py`` (NumPy there and here, so
every phantom is bit-equal to the JAX one): 3D Shepp-Logan, a uniform
ball, nested cubes and a laminography-style "chip" slab.  CT volumes of
real patients are not redistributable, so these phantoms make the
pipeline self-contained end to end.
"""

from __future__ import annotations

import numpy as np

# 3D Shepp-Logan ellipsoids (Kak & Slaney variant, intensity-adjusted):
# (value, a, b, c, x0, y0, z0, phi_deg) — semi-axes/centers in [-1, 1].
_SHEPP_LOGAN = [
    (1.00, 0.690, 0.920, 0.810, 0.0, 0.0, 0.0, 0.0),
    (-0.80, 0.6624, 0.8740, 0.780, 0.0, -0.0184, 0.0, 0.0),
    (-0.20, 0.1100, 0.3100, 0.220, 0.22, 0.0, 0.0, -18.0),
    (-0.20, 0.1600, 0.4100, 0.280, -0.22, 0.0, 0.0, 18.0),
    (0.10, 0.2100, 0.2500, 0.410, 0.0, 0.35, -0.15, 0.0),
    (0.10, 0.0460, 0.0460, 0.050, 0.0, 0.1, 0.25, 0.0),
    (0.10, 0.0460, 0.0460, 0.050, 0.0, -0.1, 0.25, 0.0),
    (0.10, 0.0460, 0.0230, 0.050, -0.08, -0.605, 0.0, 0.0),
    (0.10, 0.0230, 0.0230, 0.020, 0.0, -0.606, 0.0, 0.0),
    (0.10, 0.0230, 0.0460, 0.020, 0.06, -0.605, 0.0, 0.0),
]


def _grid(n):
    axes = [np.linspace(-1.0, 1.0, ni, dtype=np.float32) for ni in n]
    return np.meshgrid(*axes, indexing="ij")


def shepp_logan_3d(nVoxel=(128, 128, 128)) -> np.ndarray:
    """3D Shepp-Logan phantom, values clipped to [0, 1]."""
    x, y, z = _grid(nVoxel)
    vol = np.zeros(nVoxel, np.float32)
    for val, a, b, c, x0, y0, z0, phi in _SHEPP_LOGAN:
        p = np.radians(phi)
        xr = (x - x0) * np.cos(p) + (y - y0) * np.sin(p)
        yr = -(x - x0) * np.sin(p) + (y - y0) * np.cos(p)
        zr = z - z0
        vol[(xr / a) ** 2 + (yr / b) ** 2 + (zr / c) ** 2 <= 1.0] += val
    return np.clip(vol, 0.0, 1.0)


def ball(nVoxel=(64, 64, 64), radius: float = 0.6, value: float = 1.0) -> np.ndarray:
    x, y, z = _grid(nVoxel)
    return (value * ((x**2 + y**2 + z**2) <= radius**2)).astype(np.float32)


def nested_cubes(nVoxel=(64, 64, 64)) -> np.ndarray:
    x, y, z = _grid(nVoxel)
    vol = np.zeros(nVoxel, np.float32)
    vol[(np.abs(x) < 0.7) & (np.abs(y) < 0.7) & (np.abs(z) < 0.7)] = 0.4
    vol[(np.abs(x) < 0.35) & (np.abs(y) < 0.35) & (np.abs(z) < 0.35)] = 1.0
    return vol


def lamino_chip(nVoxel=(128, 128, 32)) -> np.ndarray:
    """Flat slab with embedded high-attenuation 'interconnect' lines —
    the thin-sample geometry laminography targets (cf. the reference's
    stripped ``data/lamino_chip.npy`` scene)."""
    rng = np.random.default_rng(0)
    x, y, z = _grid(nVoxel)
    vol = np.zeros(nVoxel, np.float32)
    slab = np.abs(z) < 0.6
    vol[slab] = 0.2
    nx, ny, nz = nVoxel
    for _ in range(12):  # metal lines along x
        j = rng.integers(ny // 8, ny - ny // 8)
        k = rng.integers(nz // 4, nz - nz // 4)
        vol[:, j, k] = 1.0
    for _ in range(12):  # metal lines along y
        i = rng.integers(nx // 8, nx - nx // 8)
        k = rng.integers(nz // 4, nz - nz // 4)
        vol[i, :, k] = 1.0
    # vias along z
    for _ in range(20):
        i = rng.integers(nx // 8, nx - nx // 8)
        j = rng.integers(ny // 8, ny - ny // 8)
        vol[i, j, slab[i, j]] = 0.9
    return vol


PHANTOMS = {
    "shepp_logan": shepp_logan_3d,
    "ball": ball,
    "cubes": nested_cubes,
    "lamino_chip": lamino_chip,
}


def get_phantom(name: str, nVoxel) -> np.ndarray:
    if name not in PHANTOMS:
        raise KeyError(f"Unknown phantom {name!r}; have {sorted(PHANTOMS)}")
    return PHANTOMS[name](tuple(nVoxel))
