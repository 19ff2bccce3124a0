"""Beer-Lambert line integration along rays (attenuation, no exponentiation).

Port of the JAX ``ops/integration.py::raw2outputs``:
``acc = sum((sigma + noise) * dt * |d|)`` with the last interval padded to
1e-10, plus the fine-pass sampling weights -- |Delta sigma| between
adjacent samples for ``out_dim == 1`` (channel 2 for ``out_dim == 2``),
normalised by the max over the WHOLE batch, not per ray.
"""

from __future__ import annotations

from typing import Optional

import torch


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                raw_noise_std: float = 0.0,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
    """raw: [n_rays, n_samples, C]; z_vals: [n_rays, n_samples]; rays_d: [n_rays, 3].

    ``noise`` (standard normal, [n_rays, n_samples]) replaces the draw
    from ``generator`` when ``raw_noise_std > 0``.

    Returns (acc [n_rays], weights [n_rays, n_samples]).
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e-10)], dim=-1)
    dists = dists * torch.linalg.vector_norm(rays_d[..., None, :], dim=-1)

    sigma = raw[..., 0]
    if raw_noise_std > 0.0:
        if noise is None:
            noise = torch.randn(sigma.shape, generator=generator,
                                dtype=sigma.dtype, device=sigma.device)
        sigma = sigma + noise * raw_noise_std

    acc = torch.sum(sigma * dists, dim=-1)

    if raw.shape[-1] == 1:
        eps = torch.full_like(raw[:, :1, -1], 1e-10)
        weights = torch.cat(
            [eps, torch.abs(raw[:, 1:, -1] - raw[:, :-1, -1])], dim=-1)
        weights = weights / torch.max(weights)
    elif raw.shape[-1] == 2:
        weights = raw[..., 1] / torch.max(raw[..., 1])
    else:
        raise NotImplementedError("raw last dim must be 1 or 2")
    return acc, weights
