"""Quality metrics and masking utilities (NumPy).

The port's own copy of the JAX package's ``metrics.py``, which is pure
NumPy: complex-aware MSE, normalized projection PSNR, 3D PSNR, 3-axis mean
SSIM, image casting, and the ptycho/beam masks.  The SSIM matches
``skimage.metrics.structural_similarity`` defaults (win_size=7 uniform
filter, no gaussian weighting).
"""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------------
# MSE / PSNR
# --------------------------------------------------------------------------

def get_mse(x, y):
    """Complex-aware MSE (util.py:18-26)."""
    x = np.asarray(x)
    y = np.asarray(y)
    if np.iscomplexobj(x) or np.iscomplexobj(y):
        # identical to the reference's both-complex branch; real inputs
        # have imag == 0 so this also equals the plain-MSE branch
        return float(np.mean((x.real - y.real) ** 2 + (x.imag - y.imag) ** 2))
    return float(np.mean((x - y) ** 2))


def get_psnr(x, y):
    """Projection PSNR: magnitude, min-max normalize, -10 log10(mse)
    (util.py:29-51)."""
    x = np.abs(np.asarray(x)).astype(np.float64)
    y = np.abs(np.asarray(y)).astype(np.float64)
    if x.max() == 0 or y.max() == 0:
        return 0.0
    xn = (x - x.min()) / (x.max() - x.min())
    yn = (y - y.min()) / (y.max() - y.min())
    mse = np.mean((xn - yn) ** 2)
    if mse == 0:
        return 100.0
    return float(-10.0 * np.log10(mse))


def get_psnr_3d(arr1, arr2, size_average: bool = True, pixel_max: float = 1.0):
    """3D volume PSNR with PIXEL_MAX=1 and zero-mse -> 100 (util.py:55-84)."""
    a = np.asarray(arr1, dtype=np.float64)[np.newaxis]
    b = np.asarray(arr2, dtype=np.float64)[np.newaxis]
    mse = ((a - b) ** 2).mean(axis=(1, 2, 3))
    zero = mse == 0
    mse[zero] = 1e-10
    psnr = 20 * np.log10(pixel_max / np.sqrt(mse))
    psnr[zero] = 100.0
    return float(psnr.mean()) if size_average else psnr


# --------------------------------------------------------------------------
# SSIM (skimage-compatible: uniform 7x7(x7) window, K1=.01, K2=.03)
# --------------------------------------------------------------------------

def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """N-D uniform (box) mean filter, 'reflect' padding — matches
    scipy.ndimage.uniform_filter used inside skimage's SSIM."""
    out = x.astype(np.float64)
    for ax in range(x.ndim):
        pad_l = size // 2
        pad_r = size - 1 - pad_l
        padded = np.pad(
            out,
            [(pad_l, pad_r) if a == ax else (0, 0) for a in range(x.ndim)],
            mode="reflect",
        )
        c = np.cumsum(padded, axis=ax)
        zeros = np.zeros_like(np.take(c, [0], axis=ax))
        c = np.concatenate([zeros, c], axis=ax)
        hi = [slice(None)] * x.ndim
        lo = [slice(None)] * x.ndim
        hi[ax] = slice(size, None)
        lo[ax] = slice(0, -size)
        out = (c[tuple(hi)] - c[tuple(lo)]) / size
    return out


def structural_similarity(
    im1: np.ndarray,
    im2: np.ndarray,
    win_size: int = 7,
    data_range: float | None = None,
    K1: float = 0.01,
    K2: float = 0.03,
) -> float:
    """Mean SSIM, matching skimage defaults for float inputs.

    skimage with float input and no ``data_range`` uses ``max-min`` of
    im1... actually skimage raises for floats without data_range in recent
    versions; the reference ran an older skimage whose float default was
    ``data_range = 2.0`` (dmax-dmin of (-1, 1)).  We default to the joint
    max-min of both images, clamped below by 1e-12, which tracks the
    classical definition; tests pin exact values against a literal
    transcription oracle.
    """
    im1 = np.asarray(im1, dtype=np.float64)
    im2 = np.asarray(im2, dtype=np.float64)
    if data_range is None:
        dmin = min(im1.min(), im2.min())
        dmax = max(im1.max(), im2.max())
        data_range = max(dmax - dmin, 1e-12)

    n = win_size ** im1.ndim
    cov_norm = n / (n - 1)  # sample covariance, matching skimage

    ux = _uniform_filter(im1, win_size)
    uy = _uniform_filter(im2, win_size)
    uxx = _uniform_filter(im1 * im1, win_size)
    uyy = _uniform_filter(im2 * im2, win_size)
    uxy = _uniform_filter(im1 * im2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux**2 + uy**2 + C1) * (vx + vy + C2)
    )
    # skimage crops win_size//2 border before averaging
    pad = win_size // 2
    sl = tuple(slice(pad, s - pad) for s in S.shape)
    return float(S[sl].mean())


def get_ssim_3d(arr1, arr2, size_average: bool = True):
    """Mean of 2D-stack SSIM over the 3 axis permutations (util.py:87-139).

    The reference calls skimage's SSIM on each [N] volume treating the
    *last* axis as... it passes the full 3D array, so skimage computes a
    volumetric (3D-window) SSIM; the three permutations then differ only
    via border cropping.  We reproduce that: 3D 7x7x7-window SSIM per
    permutation, averaged.
    """
    a = np.asarray(arr1, dtype=np.float64)
    b = np.asarray(arr2, dtype=np.float64)
    perms = [(1, 2, 0), (0, 2, 1), (0, 1, 2)]
    vals = [
        structural_similarity(np.transpose(a, p), np.transpose(b, p))
        for p in perms
    ]
    return float(np.mean(vals))


# --------------------------------------------------------------------------
# Image casting / masks
# --------------------------------------------------------------------------

def cast_to_image(arr, normalize: bool = True) -> np.ndarray:
    """Magnitude + min-max normalize to [0,1], add channel dim
    (util.py:155-170, cv2.normalize MINMAX equivalent)."""
    img = np.asarray(arr)
    if np.iscomplexobj(img):
        img = np.abs(img)
    img = img.astype(np.float64)
    if normalize:
        lo, hi = img.min(), img.max()
        img = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    return img[..., np.newaxis]


def get_ptycho_mask(hr, threshold: float = 0.007) -> np.ndarray:
    """Beam mask from a (complex) full projection (util.py:196-205).

    ``mask = |hr| < thr``, then neighbor-AND down rows and across columns
    (suppresses isolated pixels), inverted: True = keep.
    """
    hr = np.asarray(hr)
    mask = np.abs(hr) < threshold
    # mask[1:] &= mask[1:] == mask[:-1]  (reference, boolean equality AND)
    mask[1:] &= mask[1:] == mask[:-1]
    mask[:, 1:] &= mask[:, 1:] == mask[:, :-1]
    return ~mask


def get_ptycho_mask_1d(projs, threshold: float = 0.007) -> np.ndarray:
    """1D/2D threshold mask variant (util.py:173-193)."""
    projs = np.asarray(projs)
    mask = np.abs(projs) > threshold
    if projs.ndim == 2:
        mask[1:] &= mask[1:] == mask[:-1]
        mask[:, 1:] &= mask[:, 1:] == mask[:, :-1]
    elif projs.ndim != 1:
        raise ValueError(f"Unsupported input dimension {projs.ndim}")
    return mask
