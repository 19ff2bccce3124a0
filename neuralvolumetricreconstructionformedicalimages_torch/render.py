"""Differentiable line-integral renderer.

Port of the JAX ``render.py``: stratified depth sampling, points clamped
to ``bound - 1e-6``, field query, Beer-Lambert integration, the optional
hierarchical fine pass and the TV terms.  ``render_image`` and
``query_field`` are the eval paths, tiled by Python loops under
``torch.no_grad``.

Randomness comes from an explicit ``torch.Generator``; with none (and no
fed draw) the coarse pass is not perturbed, as the JAX renderer without a
key.  ``t_rand`` / ``u`` / ``noise`` (the coarse pass's) feed draws in
(tests feed JAX's).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .models.density_field import DensityField
from .ops.integration import raw2outputs
from .ops.sampling import sample_pdf, stratified_z_vals
from .utils.profiling import layer_range


def tv_on_points(pts: torch.Tensor) -> torch.Tensor:
    """L1 total variation of consecutive sample points."""
    return torch.sum(torch.abs(pts[:, 1:, :] - pts[:, :-1, :]))


def _points(rays_o, rays_d, z_vals, bound):
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return torch.clamp(pts, -bound, bound)


def render_rays(
    rays: torch.Tensor,
    field: DensityField,
    *,
    n_samples: int,
    n_fine: int = 0,
    perturb: bool = True,
    raw_noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    field_fine: Optional[DensityField] = None,
    enc_params=None,
    enc_params_fine=None,
    t_rand: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Render a batch of rays [n_rays, 8] -> dict with 'acc' [n_rays] etc.

    ``enc_params`` / ``enc_params_fine``: frozen encoder params
    (``DensityField.freeze``) for the eval path.  Layer ranges: ``sample``
    (depths and points), the field's own, ``render`` (integration, TV).
    """
    with layer_range("sample"):
        rays_o, rays_d = rays[..., :3], rays[..., 3:6]
        near, far = rays[..., 6:7], rays[..., 7:8]
        do_perturb = perturb and (generator is not None or t_rand is not None)
        z_vals = stratified_z_vals(near, far, n_samples, do_perturb,
                                   generator=generator, t_rand=t_rand)
        bound = field.bound - 1e-6
        pts = _points(rays_o, rays_d, z_vals, bound)
    raw = field(pts, enc_params)

    ret: Dict[str, torch.Tensor] = {}
    if n_fine > 0 and field_fine is not None:
        with layer_range("render"):
            acc, weights = raw2outputs(raw, z_vals, rays_d, raw_noise_std, generator,
                                       noise)
        ret.update(acc0=acc, weights0=weights, pts0=pts)
        with layer_range("sample"):
            z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            z_samples = sample_pdf(z_mid, weights[..., 1:-1], n_fine,
                                   det=not perturb, generator=generator, u=u)
            z_samples = z_samples.detach()
            z_vals, _ = torch.sort(torch.cat([z_vals, z_samples], -1), dim=-1)
            pts = _points(rays_o, rays_d, z_vals, bound)
        raw = field_fine(pts, enc_params_fine)
        noise = None    # the fine pass draws its own

    with layer_range("render"):
        acc, _ = raw2outputs(raw, z_vals, rays_d, raw_noise_std, generator, noise)
        # tv_loss: TV on the sample POSITIONS (parameter-independent, zero
        # gradient; kept for parity).  tv_density: TV of the predicted
        # densities along each ray, the gradient-active "tvd" regulariser.
        ret.update(acc=acc, pts=pts, tv_loss=0.1 * tv_on_points(pts),
                   tv_density=torch.mean(torch.abs(raw[..., 1:, 0] - raw[..., :-1, 0])))
    return ret


@torch.no_grad()
def render_image(
    rays: torch.Tensor,
    field: DensityField,
    *,
    n_samples: int,
    tile: int = 4096,
    n_fine: int = 0,
    field_fine: Optional[DensityField] = None,
    enc_params=None,
    enc_params_fine=None,
) -> torch.Tensor:
    """Render a full view deterministically (eval path), ``tile`` rays at a
    time: rays [N, 8] -> acc [N]."""
    out = [
        render_rays(r, field, n_samples=n_samples, n_fine=n_fine,
                    perturb=False, raw_noise_std=0.0, generator=None,
                    field_fine=field_fine, enc_params=enc_params,
                    enc_params_fine=enc_params_fine)["acc"]
        for r in torch.split(rays, tile)
    ]
    return torch.cat(out)


@torch.no_grad()
def query_field(points: torch.Tensor, field: DensityField, *,
                tile: int = 262144, enc_params=None) -> torch.Tensor:
    """Dense field query (eval voxel grid), ``tile`` points at a time:
    [..., 3] -> [..., out_dim]."""
    prefix = points.shape[:-1]
    flat = points.reshape(-1, points.shape[-1])
    out = torch.cat([field(c, enc_params) for c in torch.split(flat, tile)])
    return out.reshape(*prefix, out.shape[-1])
