"""Depth sampling along rays: stratified uniform + inverse-CDF (hierarchical).

Port of the JAX ``ops/sampling.py``: uniform ``z = near*(1-t) + far*t``
over ``n_samples`` with an optional jitter within each bin, and
``sample_pdf`` for the fine pass.  The random draws come from an explicit
``torch.Generator`` or are passed in (``t_rand`` / ``u``), so that tests
can feed the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional

import torch


def stratified_z_vals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                      perturb: bool,
                      generator: Optional[torch.Generator] = None,
                      t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depth values [..., n_samples] along rays.

    ``near``/``far`` are [..., 1] (per-ray).  With ``perturb`` a uniform
    jitter within each bin is applied, drawn from ``generator`` unless
    ``t_rand`` (same shape as the result) is given.
    """
    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32,
                       device=near.device)
    z = near * (1.0 - t) + far * t                    # [..., n_samples]
    if perturb:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = torch.rand(z.shape, generator=generator, dtype=z.dtype,
                                device=z.device)
        z = lower + (upper - lower) * t_rand
    return z


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` new depths from a piecewise pdf.

    bins: [..., M] bin edges (z midpoints); weights: [..., M-1].  With
    ``det`` the draws are a linspace; else ``u`` or uniform draws from
    ``generator``.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [..., M]
    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                           device=cdf.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=generator, dtype=cdf.dtype,
                       device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    bins_g0 = torch.gather(bins, -1, torch.clamp(below, max=nb))
    bins_g1 = torch.gather(bins, -1, torch.clamp(above, max=nb))
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)
