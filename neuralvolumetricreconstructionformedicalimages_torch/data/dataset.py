"""Dataset layer: reference-format pickle ingestion + device-resident ray sampling.

Port of the JAX ``data/dataset.py``:

- packed rays for all views are generated on the device at load
  ("precomputed"), or regenerated per sampled pixel inside the step
  ("onthefly", chosen automatically above 1 GB of ray tensor);
- per-view valid-pixel pools (|proj| > 0) are padded to a common length
  by repetition, and a step draws ``n_rays`` uniform indices into the
  unpadded prefix of one view's pool (uniform over valid pixels, with
  replacement);
- the ptycho/beam mask is precomputed once per view.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import geometry as G
from .. import native
from ..utils.profiling import layer_range


@dataclasses.dataclass
class ProjectionDataset:
    """One split (train or val) of a scan, tensors on ``device``.

      projs:  [N, H, W] float32 (complex64 for measured phase stacks)
      rays:   [N, H, W, 8] packed [o, d, near, far] (None on the fly)
      mask:   [N, H, W] float32 beam mask (all ones without full_proj)
      pools:  [N, P] int32 valid flat-pixel pools; pool_counts [N] int32
      image:  [n1, n2, n3] float32 ground-truth volume (eval metrics)
      voxels: [n1, n2, n3, 3] float32 voxel-center world coordinates
    """

    geo: G.ConeGeometry
    split: str
    projs: torch.Tensor
    rays: Optional[torch.Tensor]
    mask: torch.Tensor
    pools: torch.Tensor
    pool_counts: torch.Tensor
    angles: np.ndarray
    near: float
    far: float
    image: Optional[torch.Tensor] = None
    voxels: Optional[torch.Tensor] = None
    n_rays: int = 1024
    ray_mode: str = "precomputed"

    @property
    def n_views(self) -> int:
        return int(self.projs.shape[0])

    @property
    def H(self) -> int:
        return int(self.projs.shape[1])

    @property
    def W(self) -> int:
        return int(self.projs.shape[2])

    @property
    def device(self) -> torch.device:
        return self.projs.device

    def arrays(self) -> Dict[str, torch.Tensor]:
        """The per-view tensors consumed by :func:`gather_view_batch`."""
        out = {
            "projs": self.projs,
            "mask": self.mask,
            "pools": self.pools,
            "pool_counts": self.pool_counts,
        }
        if self.ray_mode == "precomputed":
            out["rays"] = self.rays
        else:
            out["angles"] = torch.as_tensor(self.angles, dtype=torch.float32,
                                            device=self.device)
        return out

    def view_rays(self, i: int) -> torch.Tensor:
        """[H*W, 8] packed rays of view ``i`` (computed on demand on the fly)."""
        if self.rays is not None:
            return self.rays[i].reshape(-1, 8)
        ro, rd = G.rays_for_angle(self.geo, float(self.angles[i]), self.device)
        return G.pack_rays(ro, rd, self.near, self.far).reshape(-1, 8)


def gather_view_batch(arrays: Dict[str, torch.Tensor], view: int,
                      n_rays: int,
                      generator: Optional[torch.Generator] = None,
                      r: Optional[torch.Tensor] = None,
                      geo: Optional[G.ConeGeometry] = None,
                      near: float = 0.0, far: float = 0.0
                      ) -> Dict[str, torch.Tensor]:
    """Sample ``n_rays`` valid pixels of one view.

    ``r`` ([n_rays] int, in [0, pool_counts[view])) is the pool draw; by
    default it is ``floor(U * count)`` from ``generator`` (uniform over the
    valid pixels; drawn on the device, with no host round trip).  In the
    on-the-fly mode ``geo``/``near``/``far`` regenerate the sampled rays.
    """
    pools = arrays["pools"]
    if r is None:
        count = arrays["pool_counts"][view].to(torch.float32)
        u = torch.rand((n_rays,), generator=generator, device=pools.device)
        r = torch.minimum((u * count).long(), count.long() - 1)
    flat_idx = pools[view, r.to(pools.device).long()].long()
    projs = arrays["projs"][view].reshape(-1)[flat_idx]
    mask = arrays["mask"][view].reshape(-1)[flat_idx]
    if "rays" in arrays:
        rays = arrays["rays"][view].reshape(-1, 8)[flat_idx]
    else:
        if geo is None:
            raise ValueError("on-the-fly ray mode needs geo/near/far passed "
                             "to gather_view_batch")
        W = geo.nDetector[0]
        rows = flat_idx // W
        cols = flat_idx - rows * W
        ro, rd = G.rays_for_pixels(geo, arrays["angles"][view], rows, cols)
        rays = G.pack_rays(ro, rd, near, far)
    return {"rays": rays, "projs": projs, "mask": mask, "pix": flat_idx}


def gather_batch(arrays: Dict[str, torch.Tensor], views: torch.Tensor,
                 n_rays: int,
                 generator: Optional[torch.Generator] = None,
                 r: Optional[torch.Tensor] = None,
                 geo: Optional[G.ConeGeometry] = None,
                 near: float = 0.0, far: float = 0.0
                 ) -> Dict[str, torch.Tensor]:
    """:func:`gather_view_batch` for every view of ``views`` at once (the
    JAX step's ``vmap`` of it): ``n_rays`` pixels of each, concatenated in
    view order ([len(views) * n_rays] rays).

    ``views`` is an int64 tensor [n_batch] on the arrays' device, so a
    captured step reads its views from a buffer.  The flat arrays are
    indexed at ``view * H * W + pixel``: no step copies a view.  ``r``
    ([n_batch, n_rays]) is the pool draw; by default one ``[n_batch,
    n_rays]`` uniform draw from ``generator``, which on the CPU is the
    per-view loop's draws in order.  Bit-equal to :func:`gather_view_batch`
    view by view, concatenated.  Its work is the layer range ``batch``.
    """
    with layer_range("batch"):
        pools = arrays["pools"]
        n_batch = views.shape[0]
        _, H, W = arrays["projs"].shape
        if r is None:
            count = arrays["pool_counts"][views].to(torch.float32)[:, None]
            u = torch.rand((n_batch, n_rays), generator=generator, device=pools.device)
            r = torch.minimum((u * count).long(), count.long() - 1)
        flat_idx = pools[views[:, None], r.reshape(n_batch, n_rays).long()].long()
        idx = (views[:, None] * (H * W) + flat_idx).reshape(-1)
        projs = arrays["projs"].reshape(-1)[idx]
        mask = arrays["mask"].reshape(-1)[idx]
        if "rays" in arrays:
            rays = arrays["rays"].reshape(-1, 8)[idx]
        else:
            if geo is None:
                raise ValueError("on-the-fly ray mode needs geo/near/far passed "
                                 "to gather_batch")
            Wd = geo.nDetector[0]
            rows = flat_idx // Wd
            cols = flat_idx - rows * Wd
            ro, rd = G.rays_for_pixels(geo, arrays["angles"][views], rows, cols)
            rays = G.pack_rays(ro.reshape(-1, 3), rd.reshape(-1, 3), near, far)
        return {"rays": rays, "projs": projs, "mask": mask, "pix": flat_idx.reshape(-1)}


def load_pickle(path: str) -> Dict[str, Any]:
    """Load a reference-format scan pickle (numpy objects only; unpickle
    only files this project wrote or trusts)."""
    with open(path, "rb") as handle:
        return pickle.load(handle)


_RAY_TENSOR_BYTES_LIMIT = 1 << 30  # 1 GB: auto-switch to on-the-fly rays


def make_dataset(
    data: Dict[str, Any],
    split: str = "train",
    n_rays: int = 1024,
    mask_threshold: float = 0.007,
    use_mask: Optional[bool] = None,
    ray_mode: str = "auto",
    device="cpu",
) -> ProjectionDataset:
    """Build a dataset on ``device`` from a reference-format pickle dict.

    ``use_mask=None`` -> mask from ``full_proj`` when present, else all
    ones.  ``ray_mode``: "precomputed" | "onthefly" | "auto" (on the fly
    when the [N, H, W, 8] f32 ray tensor would exceed 1 GB).
    """
    geo = G.ConeGeometry.from_dict(data)
    near, far = G.get_near_far(geo)

    sp = data[split]
    projs = np.asarray(sp["projections"])
    projs = projs.astype(np.complex64 if np.iscomplexobj(projs) else np.float32)
    angles = np.asarray(sp["angles"], np.float32).reshape(-1)
    n_views, H, W = projs.shape

    full_proj = data.get("full_proj")
    if use_mask is None:
        use_mask = full_proj is not None
    if use_mask and full_proj is not None:
        fp = np.asarray(full_proj)
        if fp.ndim == 2:  # single full projection shared across views
            fp = np.broadcast_to(fp, (n_views,) + fp.shape)
        mask = native.ptycho_mask_batch(fp, mask_threshold)
    else:
        mask = np.ones(projs.shape, np.float32)

    pools, counts = native.build_pools(
        np.abs(projs) if np.iscomplexobj(projs) else projs)

    if ray_mode == "auto":
        ray_bytes = n_views * H * W * 8 * 4
        ray_mode = "onthefly" if ray_bytes > _RAY_TENSOR_BYTES_LIMIT else "precomputed"
    if ray_mode == "precomputed":
        ro, rd = G.rays_for_angles(geo, angles, device)
        rays = G.pack_rays(ro, rd, near, far)                    # [N, H, W, 8]
    elif ray_mode == "onthefly":
        rays = None
    else:
        raise ValueError(f"Unknown ray_mode {ray_mode!r}")

    image = data.get("image")
    voxels = None
    if image is not None:
        image = torch.as_tensor(np.asarray(image, np.float32), device=device)
        voxels = torch.as_tensor(G.voxel_grid(geo), device=device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return ProjectionDataset(
        geo=geo, split=split, projs=dev(projs), rays=rays, mask=dev(mask),
        pools=dev(pools), pool_counts=dev(counts), angles=angles,
        near=near, far=far, image=image, voxels=voxels, n_rays=n_rays,
        ray_mode=ray_mode,
    )


def load_dataset(path: str, split: str = "train", n_rays: int = 1024,
                 device="cpu", **kw) -> ProjectionDataset:
    """Load a reference-format pickle file into a dataset on ``device``."""
    return make_dataset(load_pickle(path), split=split, n_rays=n_rays,
                        device=device, **kw)
