"""Scan geometry: TIGRE-convention cone/parallel-beam + tilted-axis laminography.

Port of the JAX ``geometry.py`` (same conventions):

- all lengths converted mm -> m on ingestion;
- detector pixel (row r, col c) maps to
  ``u = (c + 0.5 - W/2) * dDetector[0] + offDetector[0]``,
  ``v = (r + 0.5 - H/2) * dDetector[1] + offDetector[1]``
  (``nDetector = [W, H]``);
- pose ``R3(theta, z) @ R2(pi/2, z) @ R1(-pi/2, x) @ R4(tilt, clockwise-x)``
  with translation ``[DSO cos, DSO sin, DSO tan(tilt)]``;
- near/far from the max in-plane distance of the volume corners.

Precision: reduced-precision contractions move ray origins by detector
pixels, so the pose products are taken in float64 and the ray
contractions as explicit float32 multiply-and-sum (never a TF32 matmul).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ConeGeometry:
    """Static scan geometry; all distances in meters."""

    DSD: float                      # distance source -> detector (m)
    DSO: float                      # distance source -> origin (m)
    nDetector: Tuple[int, int]      # detector pixels, (W, H)
    dDetector: Tuple[float, float]  # pixel size (m)
    nVoxel: Tuple[int, int, int]    # voxels
    dVoxel: Tuple[float, float, float]  # voxel size (m)
    offOrigin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    offDetector: Tuple[float, float] = (0.0, 0.0)
    accuracy: float = 0.5
    mode: str = "cone"              # "cone" | "parallel"
    filter: Any = None
    tilt_angle: float = 0.0         # laminography tilt (degrees)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ConeGeometry":
        """Build from a reference-format pickle dict (mm -> m)."""
        return cls(
            DSD=float(data["DSD"]) / 1000.0,
            DSO=float(data["DSO"]) / 1000.0,
            nDetector=tuple(int(x) for x in data["nDetector"]),
            dDetector=tuple(float(x) / 1000.0 for x in np.asarray(data["dDetector"]).ravel()),
            nVoxel=tuple(int(x) for x in data["nVoxel"]),
            dVoxel=tuple(float(x) / 1000.0 for x in np.asarray(data["dVoxel"]).ravel()),
            offOrigin=tuple(float(x) / 1000.0 for x in np.asarray(data["offOrigin"]).ravel()),
            offDetector=tuple(float(x) / 1000.0 for x in np.asarray(data["offDetector"]).ravel()[:2]),
            accuracy=float(data.get("accuracy", 0.5)),
            mode=str(data["mode"]),
            filter=None,
            tilt_angle=float(data.get("tilt_angle", 0.0)),
        )

    @property
    def sDetector(self) -> Tuple[float, float]:
        return (self.nDetector[0] * self.dDetector[0], self.nDetector[1] * self.dDetector[1])

    @property
    def sVoxel(self) -> Tuple[float, float, float]:
        return tuple(n * d for n, d in zip(self.nVoxel, self.dVoxel))


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] as multiply-and-sum (no TF32 path)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


@functools.lru_cache(maxsize=None)
def _r21_on(device: torch.device) -> torch.Tensor:
    """``R2(pi/2, z) @ R1(-pi/2, x)`` in float64 on ``device``, made once per
    device: a pose then copies nothing from the host, so a step that makes
    rays on the fly can be captured in a CUDA graph."""
    phi1 = -np.pi / 2
    R1 = np.array([[1.0, 0.0, 0.0],
                   [0.0, np.cos(phi1), -np.sin(phi1)],
                   [0.0, np.sin(phi1), np.cos(phi1)]], dtype=np.float32)
    phi2 = np.pi / 2
    R2 = np.array([[np.cos(phi2), -np.sin(phi2), 0.0],
                   [np.sin(phi2), np.cos(phi2), 0.0],
                   [0.0, 0.0, 1.0]], dtype=np.float32)
    return torch.as_tensor((R2 @ R1).astype(np.float64), device=device)


def angle_to_pose(DSO: float, angle, tilt_angle_deg: float,
                  device="cpu") -> torch.Tensor:
    """4x4 pose of the source/detector frame at scan angle ``angle`` (rad).

    ``rot = R3(angle, z) @ R2(pi/2, z) @ R1(-pi/2, x) @ R4(tilt, clockwise-x)``
    and ``trans = [DSO cos, DSO sin, DSO tan(tilt)]``, computed in float64
    and returned as float32 ``[..., 4, 4]``.
    """
    angle = torch.as_tensor(angle, dtype=torch.float32, device=device).to(torch.float64)
    tilt = float(np.radians(tilt_angle_deg))
    c, s = torch.cos(angle), torch.sin(angle)
    ct, st = float(np.cos(tilt)), float(np.sin(tilt))
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R21 = _r21_on(angle.device)

    R3 = torch.stack([
        torch.stack([c, -s, zero], -1),
        torch.stack([s, c, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    R4 = torch.stack([
        torch.stack([one, zero, zero], -1),
        torch.stack([zero, ct * one, st * one], -1),
        torch.stack([zero, -st * one, ct * one], -1),
    ], -2)
    rot = _matmul3(_matmul3(R3, R21.expand_as(R3)), R4)
    trans = torch.stack([DSO * c, DSO * s, DSO * np.tan(tilt) * one], -1)

    pose = torch.zeros(angle.shape + (4, 4), dtype=torch.float64, device=angle.device)
    pose[..., :3, :3] = rot
    pose[..., :3, 3] = trans
    pose[..., 3, 3] = 1.0
    return pose.to(torch.float32)


def detector_uv(geo: ConeGeometry, device="cpu"):
    """Detector-plane coordinates per pixel, shape [H, W] each."""
    W, H = geo.nDetector
    cols = torch.arange(W, dtype=torch.float32, device=device)
    rows = torch.arange(H, dtype=torch.float32, device=device)
    u = (cols[None, :] + 0.5 - W / 2) * geo.dDetector[0] + geo.offDetector[0]
    v = (rows[:, None] + 0.5 - H / 2) * geo.dDetector[1] + geo.offDetector[1]
    return u.expand(H, W), v.expand(H, W)


def _apply_rot(R: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """``R @ v`` for [..., 3] vectors, R [3, 3] or batched [N, 1.., 3, 3]."""
    return (R * vecs[..., None, :]).sum(-1)


def _rays(geo: ConeGeometry, pose: torch.Tensor, u: torch.Tensor,
          v: torch.Tensor):
    """Rays through detector coordinates (u, v) [...] for ``pose``
    broadcastable to [..., 4, 4]."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    if geo.mode == "cone":
        dirs = torch.stack([u / geo.DSD, v / geo.DSD, torch.ones_like(u)], -1)
        rays_d = _apply_rot(R, dirs)
        rays_o = t.expand_as(rays_d)
    elif geo.mode == "parallel":
        z = torch.zeros_like(u)
        rays_d = _apply_rot(R, torch.stack([z, z, torch.ones_like(u)], -1))
        rays_o = _apply_rot(R, torch.stack([u, v, z], -1)) + t
    else:
        raise NotImplementedError(f"Unknown CT scanner mode {geo.mode!r}")
    return rays_o.contiguous(), rays_d.contiguous()


def rays_for_angle(geo: ConeGeometry, angle, device="cpu"):
    """Ray bundle for one scan angle: (origins, dirs), each [H, W, 3].

    Cone mode: ``d = R @ [u/DSD, v/DSD, 1]`` (unnormalised; the integrator
    multiplies path lengths by ``|d|``), origin = source position.
    Parallel mode: ``d = R @ [0,0,1]``, origins on the rotated detector plane.
    """
    pose = angle_to_pose(geo.DSO, angle, geo.tilt_angle, device)
    u, v = detector_uv(geo, device)
    return _rays(geo, pose[None, None], u, v)


def rays_for_angles(geo: ConeGeometry, angles, device="cpu"):
    """Ray bundles for many angles: [n_angles, H, W, 3] origins and dirs."""
    angles = torch.as_tensor(np.asarray(angles, np.float32), device=device)
    pose = angle_to_pose(geo.DSO, angles, geo.tilt_angle, device)  # [N, 4, 4]
    u, v = detector_uv(geo, device)
    return _rays(geo, pose[:, None, None], u[None], v[None])


def rays_for_pixels(geo: ConeGeometry, angle, rows: torch.Tensor,
                    cols: torch.Tensor):
    """Rays for a subset of detector pixels of one view: ([P, 3], [P, 3]).

    Same math as :func:`rays_for_angle` restricted to the sampled pixels
    (the on-the-fly ray mode of ``data/dataset.py``).  With ``angle`` [N]
    and ``rows``/``cols`` [N, P] (P pixels of each of N views), ([N, P, 3],
    [N, P, 3]), each view's rays the values of its own call.
    """
    pose = angle_to_pose(geo.DSO, angle, geo.tilt_angle, rows.device)
    W, H = geo.nDetector
    u = (cols.to(torch.float32) + 0.5 - W / 2) * geo.dDetector[0] + geo.offDetector[0]
    v = (rows.to(torch.float32) + 0.5 - H / 2) * geo.dDetector[1] + geo.offDetector[1]
    return _rays(geo, pose[..., None, :, :], u, v)


def get_near_far(geo: ConeGeometry, tolerance: float = 0.005) -> Tuple[float, float]:
    """Near/far planes from the max in-plane corner distance."""
    off = np.asarray(geo.offOrigin, dtype=np.float64)
    s = np.asarray(geo.sVoxel, dtype=np.float64)
    dists = [
        np.linalg.norm([off[0] + sx * s[0] / 2, off[1] + sy * s[1] / 2])
        for sx in (-1, 1) for sy in (-1, 1)
    ]
    dist_max = float(np.max(dists))
    near = max(0.0, geo.DSO - dist_max - tolerance)
    far = min(geo.DSO * 2, geo.DSO + dist_max + tolerance)
    return float(near), float(far)


def get_near_far_tilted(geo: ConeGeometry, tolerance: float = 0.005) -> Tuple[float, float]:
    """Tilt-aware near/far: full 3D distance to the 8 corners of the volume."""
    off = np.asarray(geo.offOrigin, dtype=np.float64)
    s = np.asarray(geo.sVoxel, dtype=np.float64)
    dists = [
        np.linalg.norm(off + np.array([sx, sy, sz]) * s / 2)
        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
    ]
    dist_max = float(np.max(dists))
    near = max(0.0, geo.DSO - dist_max - tolerance)
    far = min(geo.DSO * 2, geo.DSO + dist_max + tolerance)
    return float(near), float(far)


def voxel_grid(geo: ConeGeometry) -> np.ndarray:
    """World coordinates of voxel centers, [n1, n2, n3, 3] float32."""
    n1, n2, n3 = geo.nVoxel
    s = np.asarray(geo.sVoxel) / 2 - np.asarray(geo.dVoxel) / 2
    xs = np.linspace(-s[0], s[0], n1, dtype=np.float32)
    ys = np.linspace(-s[1], s[1], n2, dtype=np.float32)
    zs = np.linspace(-s[2], s[2], n3, dtype=np.float32)
    return np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1)


def pack_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, near: float,
              far: float) -> torch.Tensor:
    """Pack to the 8-float ray layout [o(3), d(3), near, far].  near and
    far are filled on the rays' device (no host-to-device copy)."""
    shape = rays_o.shape[:-1] + (1,)
    return torch.cat([rays_o, rays_d, rays_o.new_full(shape, near),
                      rays_o.new_full(shape, far)], dim=-1)
