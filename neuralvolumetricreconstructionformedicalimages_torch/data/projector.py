"""Forward projector: the X-ray transform of a voxel volume, in PyTorch.

Port of the JAX package's ``data/projector.py``.  The synthetic data
generator projects a volume with the same ray geometry the renderer uses
for the neural field (ray generation -> trilinear volume sampling ->
Beer-Lambert sum), so a reconstructed volume reprojects onto the data it
was trained on with no convention mismatch.

The voxel layout matches ``geometry.voxel_grid``: ``volume[i, j, k]`` is
the attenuation at world position ``grid[i, j, k]``, axes (x, y, z),
voxel centers spanning ``+-(sVoxel/2 - dVoxel/2)``.

:func:`project_angles` runs on the volume's device, the card by default;
:func:`project_angles_parallel_cpu` is the host's affine path for
parallel beams (SciPy).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import geometry as G

_EPS = 1e-4   # boundary voxel centers are not zeroed by fp rounding
_TILE_BYTES = 1 << 27   # bytes of a row tile's [rows, W, S, 3] f32 points


def trilinear_sample(volume: torch.Tensor, pts: torch.Tensor,
                     geo: G.ConeGeometry) -> torch.Tensor:
    """Trilinearly sample ``volume`` [n1, n2, n3] at world points ``pts`` [..., 3].

    Points outside the volume sample zero (attenuation-free surroundings):
    the 8 corner indices are clamped to the volume and the value is zeroed
    where any axis of the voxel coordinate lies outside
    ``[-1e-4, n - 1 + 1e-4]``.  (``F.grid_sample``'s zero padding would
    give partial weights in the ring of boundary voxels instead.)
    """
    dev = pts.device
    n = torch.tensor(geo.nVoxel, dtype=torch.float32, device=dev)
    d = torch.tensor(geo.dVoxel, dtype=torch.float32, device=dev)
    half = (n * d) / 2.0 - d / 2.0   # first/last voxel center coordinate

    # continuous voxel-index coordinates: center i at world -half + i*d
    f = (pts + half) / d
    f0 = torch.floor(f)
    frac = f - f0
    inside = ((f >= -_EPS) & (f <= n - 1.0 + _EPS)).all(dim=-1)

    # corner indices clamped to the volume, as one flat index per corner:
    # the (0, 0, 0) corner plus the clamped step along each axis
    top = torch.tensor(geo.nVoxel, dtype=torch.long, device=dev) - 1
    i0 = f0.long()
    c0 = torch.minimum(torch.clamp(i0, min=0), top)
    step = torch.minimum(torch.clamp(i0 + 1, min=0), top) - c0
    _, n2, n3 = geo.nVoxel
    strides = torch.tensor([n2 * n3, n3, 1], dtype=torch.long, device=dev)
    base = (c0 * strides).sum(dim=-1)
    sx, sy, sz = (step * strides).unbind(-1)
    flat = volume.reshape(-1)

    wx, wy, wz = frac.unbind(-1)
    ux, uy, uz = 1 - wx, 1 - wy, 1 - wz
    v = (
        flat[base] * ux * uy * uz
        + flat[base + sx] * wx * uy * uz
        + flat[base + sy] * ux * wy * uz
        + flat[base + sz] * ux * uy * wz
        + flat[base + sx + sy] * wx * wy * uz
        + flat[base + sx + sz] * wx * uy * wz
        + flat[base + sy + sz] * ux * wy * wz
        + flat[base + sx + sy + sz] * wx * wy * wz
    )
    return torch.where(inside, v, torch.zeros_like(v))


def project_angles(volume, geo: G.ConeGeometry, angles, n_samples: int = 0,
                   device=None) -> torch.Tensor:
    """X-ray transform: projections [n_angles, H, W] (float32) of ``volume``.

    ``n_samples`` = samples per ray (0 -> ``2 * max(nVoxel)``, about one
    sample per voxel diagonal step).  Each ray is sampled at ``linspace``
    depths from near to far and the trilinear samples are summed times
    ``dt * |d|``.  Detector rows are taken in tiles that keep the
    [rows, W, S, 3] point tensor near 128 MB; the height is padded up to a
    multiple of the tile and the padding rows are dropped.

    Runs on ``device``; by default on the volume's device when it is a
    tensor, else on the card.

    A sample within an ulp of the edge of the in-volume band adds or drops
    a whole boundary voxel's value, so two programs that round a ray's
    points differently (another device, another compiler's fused
    multiply-adds) can differ at a few pixels by one sample,
    ``max(volume) * dt * |d|``; elsewhere they agree to float32 rounding.
    """
    if device is None and isinstance(volume, torch.Tensor):
        dev = volume.device
    else:
        # the card, or it raises; imported here since the trainer imports data/
        from ..train.trainer import resolve_device

        dev = resolve_device(device)
    vol = torch.as_tensor(volume, dtype=torch.float32, device=dev).contiguous()
    angles = np.asarray(angles, np.float32).reshape(-1)
    near, far = G.get_near_far(geo)
    if n_samples == 0:
        n_samples = 2 * int(np.max(geo.nVoxel))

    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=dev)
    z_vals = near * (1.0 - t) + far * t                     # [S]
    dt = (far - near) / (n_samples - 1)

    W_det, H_det = geo.nDetector
    budget_rows = max(1, _TILE_BYTES // max(1, W_det * n_samples * 12))
    row_tile = min(H_det, budget_rows)
    n_tiles = -(-H_det // row_tile)
    pad_rows = n_tiles * row_tile - H_det

    out = torch.empty((len(angles), H_det, W_det), dtype=torch.float32, device=dev)
    for a, angle in enumerate(angles):
        ro, rd = G.rays_for_angle(geo, angle, dev)         # [H, W, 3] f32
        norm = torch.linalg.vector_norm(rd, dim=-1)         # [H, W]
        ro_p = torch.nn.functional.pad(ro, (0, 0, 0, 0, 0, pad_rows))
        rd_p = torch.nn.functional.pad(rd, (0, 0, 0, 0, 0, pad_rows))
        sig = torch.empty((n_tiles * row_tile, W_det), dtype=torch.float32,
                          device=dev)
        for r0 in range(0, n_tiles * row_tile, row_tile):
            ro_r = ro_p[r0:r0 + row_tile]                   # [T, W, 3]
            rd_r = rd_p[r0:r0 + row_tile]
            pts = ro_r[..., None, :] + rd_r[..., None, :] * z_vals[:, None]
            sig[r0:r0 + row_tile] = trilinear_sample(vol, pts, geo).sum(dim=-1)
        out[a] = sig[:H_det] * dt * norm
    return out


def project_angles_parallel_cpu(volume, geo: G.ConeGeometry, angles,
                                n_samples: int = 0) -> np.ndarray:
    """X-ray transform on the host CPU for PARALLEL-beam geometries.

    For a parallel beam the sample point of detector pixel (u, v) at depth
    step s is an affine function of (v, u, s) -- rays share one direction
    and origins vary linearly across the detector plane -- so each view is
    one ``scipy.ndimage.affine_transform`` (trilinear resample) followed by
    a sum over the depth axis.  Matches :func:`project_angles` to
    interpolation accuracy.  Empty ``angles`` give an empty [0, H, W]
    array.
    """
    from scipy.ndimage import affine_transform

    if geo.mode != "parallel":
        raise NotImplementedError("affine fast path requires parallel mode")
    if n_samples == 0:
        n_samples = 2 * int(np.max(geo.nVoxel))
    vol = np.asarray(volume, np.float32)
    near, far = G.get_near_far(geo)
    dt = (far - near) / (n_samples - 1)
    n = np.asarray(geo.nVoxel, np.float32)
    d = np.asarray(geo.dVoxel, np.float32)
    half = (n * d) / 2.0 - d / 2.0
    W_det, H_det = geo.nDetector

    angles = np.asarray(angles, np.float32).reshape(-1)
    out = np.empty((len(angles), H_det, W_det), np.float32)
    for i, ang in enumerate(angles):
        ro, rd = G.rays_for_angle(geo, float(ang))          # [H, W, 3]
        ro = ro.numpy().astype(np.float64)
        rd0 = rd.numpy().astype(np.float64)[0, 0]           # shared direction
        # world point of output sample (v, u, s):
        #   p = ro[0, 0] + dv*v + du*u + rd0*(near + dt*s)
        dv = ro[1, 0] - ro[0, 0] if H_det > 1 else np.zeros(3)
        du = ro[0, 1] - ro[0, 0] if W_det > 1 else np.zeros(3)
        base = ro[0, 0] + rd0 * float(near)
        # affine_transform: input_idx = M @ out_idx + offset, and the
        # sampling convention idx = (p + half) / d (see trilinear_sample)
        M = np.stack([dv, du, rd0 * float(dt)], axis=1) / d[:, None]
        off = (base + half) / d
        # chunk the depth axis: a full [H, W, S] f32 buffer at real-scan
        # sizes is ~1.3 GB; 64-sample slabs keep it ~270 MB.
        acc = np.zeros((H_det, W_det), np.float64)
        for s0 in range(0, n_samples, 64):
            ns = min(64, n_samples - s0)
            off_s = off + M[:, 2] * s0
            sampled = affine_transform(
                vol, M, offset=off_s, output_shape=(H_det, W_det, ns),
                order=1, mode="constant", cval=0.0)
            acc += sampled.sum(axis=-1, dtype=np.float64)
        out[i] = acc.astype(np.float32) * float(dt) * float(np.linalg.norm(rd0))
    return out
