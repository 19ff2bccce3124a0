"""3D scan-geometry debug visualization.

Port of the JAX package's ``utils/draw.py`` (NumPy there and here): the
rays, camera poses and bounding box of a scan as plain ``LineSet3D``
records, rendered to PNG with matplotlib's 3D axes (imported lazily,
inside the functions that draw).  ``plot_scan_geometry`` takes its rays
and poses from the port's ``geometry``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class LineSet3D:
    """Backend-independent line set: points [P,3], lines [E,2] int,
    colors [E,3] in [0,1]."""

    points: np.ndarray
    lines: np.ndarray
    colors: np.ndarray

    def __add__(self, other: "LineSet3D") -> "LineSet3D":
        offset = self.points.shape[0]
        return LineSet3D(
            points=np.vstack([self.points, other.points]),
            lines=np.vstack([self.lines, other.lines + offset]),
            colors=np.vstack([self.colors, other.colors]),
        )

    def segments(self) -> np.ndarray:
        """[E, 2, 3] line segment endpoints (for Line3DCollection)."""
        return self.points[self.lines]


def _lineset(points, lines, colors=None) -> LineSet3D:
    points = np.asarray(points, np.float64).reshape(-1, 3)
    lines = np.asarray(lines, np.int64).reshape(-1, 2)
    if colors is None:
        colors = np.tile([[0.2, 0.2, 0.2]], (lines.shape[0], 1))
    colors = np.asarray(colors, np.float64).reshape(-1, 3)
    if colors.shape[0] == 1:
        colors = np.tile(colors, (lines.shape[0], 1))
    return LineSet3D(points, lines, colors)


def plot_rays(ray_directions: np.ndarray, ray_origins: np.ndarray,
              ray_length: float) -> LineSet3D:
    """Frustum of the 4 corner rays of a detector.

    ray_directions/ray_origins: [W, H, 3]; returns the 4 corner rays plus
    the far-plane rectangle connecting their endpoints.
    """
    rd = np.asarray(ray_directions)
    ro = np.asarray(ray_origins)
    W, H, _ = rd.shape
    corners = [(0, 0), (W - 1, 0), (W - 1, H - 1), (0, H - 1)]
    oris = np.stack([ro[i, j] for i, j in corners])
    ends = np.stack([ro[i, j] + rd[i, j] * ray_length for i, j in corners])
    lines = [[0, 4], [1, 5], [2, 6], [3, 7], [4, 5], [5, 6], [6, 7], [7, 4]]
    return _lineset(np.vstack([oris, ends]), lines)


def plot_camera_pose(pose: np.ndarray) -> LineSet3D:
    """World frame + posed camera frame as RGB axis triads."""
    pose = np.asarray(pose, np.float64)
    colorlines = [[1, 0, 0], [0, 1, 0], [0, 0, 1]]
    origin = np.array([[0.0], [0.0], [0.0], [1.0]])
    axes = np.array([
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0],
        [1.0, 1.0, 1.0],
    ])
    world_pts = np.vstack([origin.T, axes.T])[:, :-1]
    world = _lineset(world_pts, [[0, 1], [0, 2], [0, 3]], colorlines)
    axes_trans = pose @ axes
    origin_trans = pose @ origin
    cam_pts = np.vstack([origin_trans.T, axes_trans.T])[:, :-1]
    cam = _lineset(cam_pts, [[0, 1], [0, 2], [0, 3]], colorlines)
    return cam + world


def plot_cube(cube_center: np.ndarray, cube_size: np.ndarray) -> LineSet3D:
    """Axis triad (0.3x scaled) + red bounding box."""
    center = np.asarray(cube_center, np.float64).reshape(3)
    size = np.asarray(cube_size, np.float64).reshape(3)

    unit = 0.3
    axes_pts = np.vstack([
        np.zeros((1, 3)),
        np.diag(unit * size),
    ]) + center
    frame = _lineset(axes_pts, [[0, 1], [0, 2], [0, 3]],
                     [[1, 0, 0], [0, 1, 0], [0, 0, 1]])

    xyz_min = center - 0.5 * size
    xyz_max = center + 0.5 * size
    pts = np.array([
        [xyz_min[0], xyz_min[1], xyz_min[2]],
        [xyz_max[0], xyz_min[1], xyz_min[2]],
        [xyz_min[0], xyz_max[1], xyz_min[2]],
        [xyz_max[0], xyz_max[1], xyz_min[2]],
        [xyz_min[0], xyz_min[1], xyz_max[2]],
        [xyz_max[0], xyz_min[1], xyz_max[2]],
        [xyz_min[0], xyz_max[1], xyz_max[2]],
        [xyz_max[0], xyz_max[1], xyz_max[2]],
    ])
    lines = [[0, 1], [0, 2], [1, 3], [2, 3], [4, 5], [4, 6], [5, 7], [6, 7],
             [0, 4], [1, 5], [2, 6], [3, 7]]
    bbox = _lineset(pts, lines, [[1, 0, 0]])
    return bbox + frame


def draw_scene(linesets: Sequence[LineSet3D], path: Optional[str] = None,
               elev: float = 20.0, azim: float = -60.0):
    """Render line sets to a matplotlib 3D axes; save PNG when ``path``.

    Returns the Figure (caller closes).  Headless-safe (Agg).
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    all_pts = []
    for ls in linesets:
        ax.add_collection3d(Line3DCollection(ls.segments(), colors=ls.colors))
        all_pts.append(ls.points)
    if all_pts:
        pts = np.vstack(all_pts)
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        pad = 0.05 * max(float((hi - lo).max()), 1e-6)
        ax.set_xlim(lo[0] - pad, hi[0] + pad)
        ax.set_ylim(lo[1] - pad, hi[1] + pad)
        ax.set_zlim(lo[2] - pad, hi[2] + pad)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_scan_geometry(geo, angles, ray_length: Optional[float] = None,
                       path: Optional[str] = None):
    """One-call debug view of a scan: rays + poses + reconstruction bbox."""
    from .. import geometry as G

    sets = [plot_cube(np.zeros(3), np.asarray(geo.sVoxel))]
    if ray_length is None:
        ray_length = float(geo.DSO * 2.0)
    for ang in np.atleast_1d(angles):
        ro, rd = G.rays_for_angle(geo, float(ang))
        ro = ro.numpy()
        rd = rd.numpy()
        sets.append(plot_rays(rd.transpose(1, 0, 2), ro.transpose(1, 0, 2),
                              ray_length))
        pose = G.angle_to_pose(geo.DSO, float(ang), geo.tilt_angle).numpy()
        sets.append(plot_camera_pose(pose))
    return draw_scene(sets, path=path)


# ---------------------------------------------------------------------------
# Sampling-debug utilities
# ---------------------------------------------------------------------------

def manual_vmap(func, inputs, *args, **kwargs):
    """Apply ``func`` per batch element and stack (host-side debug code;
    ``torch.vmap`` is the batched form for tensors)."""
    return np.stack([np.asarray(func(inp, *args, **kwargs)) for inp in inputs])


def visualize_sampled_points(full_mask, sampled_coords, mask_sampled,
                             global_step: int, outdir: str = "."):
    """Scatter the per-step sampled pixels over the beam mask: left = all sampled points, right = valid (red)
    vs masked-out (blue).  Saves a PNG; returns its path."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    full_mask = np.asarray(full_mask)
    coords = np.asarray(sampled_coords)
    msk = np.asarray(mask_sampled)
    valid, invalid = coords[msk > 0], coords[msk == 0]

    fig, ax = plt.subplots(1, 2, figsize=(12, 6))
    ax[0].imshow(full_mask, cmap="gray", origin="upper")
    ax[0].scatter(coords[:, 1], coords[:, 0], c="yellow", s=2,
                  label="Sampled Points")
    ax[0].set_title("Full Mask with Sampled Points")
    ax[0].legend(loc="upper right")
    ax[1].imshow(full_mask, cmap="gray", origin="upper")
    if len(valid):
        ax[1].scatter(valid[:, 1], valid[:, 0], c="red", s=2, label="Valid Points")
    if len(invalid):
        ax[1].scatter(invalid[:, 1], invalid[:, 0], c="blue", s=2,
                      label="Invalid Points")
    ax[1].set_title("Full Mask with Valid (Red) and Invalid (Blue) Points")
    ax[1].legend(loc="upper right")
    plt.tight_layout()
    path = os.path.join(outdir, f"sampled_points_visualization_step_{global_step}.png")
    plt.savefig(path)
    plt.close(fig)
    return path


def visualize_after_mask(full_mask, sampled_coords, projs_values,
                         global_step: int, title_suffix: str = "",
                         outdir: str = "."):
    """Scatter sampled pixels colored by post-mask value (zero vs nonzero).
    Saves a PNG; returns its path."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    full_mask = np.asarray(full_mask)
    coords = np.asarray(sampled_coords)
    vals = np.asarray(projs_values)
    valid, invalid = coords[vals != 0], coords[vals == 0]

    fig, ax = plt.subplots(1, 1, figsize=(8, 6))
    ax.imshow(full_mask, cmap="gray", origin="upper")
    if len(valid):
        ax.scatter(valid[:, 1], valid[:, 0], c="green", s=2, label="Valid Points")
    if len(invalid):
        ax.scatter(invalid[:, 1], invalid[:, 0], c="purple", s=2,
                   label="Invalid Points")
    ax.set_title(f"Full Mask with Points after Mask Application {title_suffix}")
    ax.legend(loc="upper right")
    plt.tight_layout()
    path = os.path.join(
        outdir, f"points_after_mask_step_{global_step}{title_suffix}.png")
    plt.savefig(path)
    plt.close(fig)
    return path
