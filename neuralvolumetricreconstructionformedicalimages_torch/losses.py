"""Loss calculators and config-driven loss selection (``cfg["train"]["loss"]``).

Port of the JAX ``losses.py``:

- the single-loss calculators: each takes a ``loss`` dict, adds its term
  into ``loss["loss"]`` and records the component under its own key;
- ``masked_mse``: a mask-weighted mean, the same estimator as selecting
  the masked rays;
- ``get_loss_fn``: ``train.loss`` names a primary per-ray term, optionally
  composed with additive regularizers via ``+``, e.g. ``"mse"``,
  ``"huber"``, ``"mse+small"``, ``"l1+tvd:0.05"``; with a process
  ``group`` its means are exact global means over the group's ranks.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _phase01(x):
    return (torch.angle(x) + math.pi) / (2 * math.pi)


def _gmean(x, mask=None):
    """Mean of ``x``, or its ``mask``-weighted mean."""
    if mask is None:
        return torch.mean(x)
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, through which autograd
    sees only this rank's own term: ``x + (all_reduce(x) - x).detach()``.
    Summing the ranks' gradients then gives the gradient of the global
    value once."""
    total = x.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return x + (total - x.detach())


def _global_mean(x, mask, group):
    """``_gmean`` over the concatenated batch of ``group``'s ranks."""
    if mask is None:
        num = torch.sum(x)
        den = x.new_full((), float(x.numel()))   # filled on the device: no sync
    else:
        m = mask.to(x.dtype)
        num, den = torch.sum(x * m), torch.sum(m).detach()
    dist.all_reduce(den, op=dist.ReduceOp.SUM, group=group)
    if mask is not None:
        den = torch.clamp(den, min=1.0)
    return global_sum(num, group) / den


def fourier_transform(x):
    return torch.fft.fft2(x)


def inverse_fourier_transform(x):
    return torch.fft.ifft2(x)


def masked_mse(pred, target, mask=None):
    """Mean squared error over ``mask``-selected entries (static-shaped):
    ``mean((target[mask] - pred[mask])**2)`` without dynamic shapes.
    ``mask`` is float/bool broadcastable to pred."""
    return _gmean((target - pred) ** 2, mask)


def calc_mse_loss(loss, x, y, tv_loss=None):
    """Primary MSE loss, plus ``tv_loss`` when given."""
    loss_mse = torch.mean((x - y) ** 2)
    loss["loss"] = loss.get("loss", 0.0) + loss_mse
    loss["loss_mse"] = loss_mse
    if tv_loss is not None:
        loss["loss"] = loss["loss"] + tv_loss
        loss["tv_loss"] = tv_loss
    return loss


def calc_mse_loss_mask(loss, x, y, mask=None):
    """Masked MSE, static-shaped."""
    loss_mse = masked_mse(y, x, mask)
    loss["loss"] = loss.get("loss", 0.0) + loss_mse
    loss["loss_mse"] = loss_mse
    return loss


def calc_phase_only_loss(loss, x, y):
    """Phase-normalized MSE for complex fields."""
    l = torch.mean((_phase01(x) - _phase01(y)) ** 2)
    loss["loss"] = loss.get("loss", 0.0) + l
    loss["phase_loss"] = l
    return loss


def calc_hinge_loss(loss, x, y):
    """Hinge loss."""
    l = torch.mean(torch.clamp(1 - x * y, min=0))
    loss["loss"] = loss.get("loss", 0.0) + l
    loss["loss_hinge"] = l
    return loss


def calc_mse_loss_with_gradient(loss, x, y, mask=None, lambda_grad=0.1):
    """MSE + finite-difference gradient regularizer (2D inputs)."""
    if mask is not None:
        x = x * mask
        y = y * mask
    loss_mse = torch.mean((x - y) ** 2)
    gx_x, gx_y = x[:, 1:] - x[:, :-1], x[1:, :] - x[:-1, :]
    gy_x, gy_y = y[:, 1:] - y[:, :-1], y[1:, :] - y[:-1, :]
    loss_grad = torch.mean((gx_x - gy_x) ** 2) + torch.mean((gx_y - gy_y) ** 2)
    loss["loss_mse"] = loss_mse
    loss["loss_grad"] = loss_grad
    loss["loss"] = loss.get("loss", 0.0) + loss_mse + lambda_grad * loss_grad
    return loss


def calc_huber_loss(loss, x, y, delta=1.0):
    """Huber loss."""
    diff = x - y
    ad = torch.abs(diff)
    l = torch.mean(torch.where(ad <= delta, 0.5 * diff ** 2,
                               delta * (ad - 0.5 * delta)))
    loss["loss"] = loss.get("loss", 0.0) + l
    loss["loss_huber"] = l
    return loss


def calc_zero_loss(loss, pred, real_data, threshold=1e-5, weight=1.0):
    """Penalize non-zero predictions where the data is ~0."""
    zero_region = (torch.abs(real_data) <= threshold).to(pred.dtype)
    l = weight * torch.mean(zero_region * pred ** 2)
    loss["loss"] = loss.get("loss", 0.0) + l
    loss["loss_zero"] = l
    return loss


def calc_small_loss(loss, pred, weight=1.0):
    """Global L2 shrinkage toward zero predictions."""
    l = weight * torch.mean(pred ** 2)
    loss["loss"] = loss.get("loss", 0.0) + l
    loss["loss_small"] = l
    return loss


def calc_tv_loss_3d(loss, x, k):
    """3D total variation, L1, per voxel."""
    if x.ndim != 3:
        raise ValueError(f"Expected 3D field, got ndim={x.ndim}")
    n1, n2, n3 = x.shape
    tv = (
        torch.abs(x[1:] - x[:-1]).sum()
        + torch.abs(x[:, 1:] - x[:, :-1]).sum()
        + torch.abs(x[:, :, 1:] - x[:, :, :-1]).sum()
    ) / (n1 * n2 * n3)
    loss["loss"] = loss.get("loss", 0.0) + tv * k
    loss["loss_tv"] = tv * k
    return loss


def calc_tv_loss(loss, image, weight):
    """2D total variation, L2, over the last two axes."""
    tv_h = torch.mean((image[..., :-1, :] - image[..., 1:, :]) ** 2)
    tv_w = torch.mean((image[..., :, :-1] - image[..., :, 1:]) ** 2)
    l = weight * (tv_h + tv_w)
    loss["loss"] = loss.get("loss", 0.0) + l
    loss["loss_tv"] = l
    return loss


def total_variation_loss(densities):
    """Mean |Delta sigma| along rays ([rays, samples])."""
    return torch.mean(torch.abs(densities[:, 1:] - densities[:, :-1]))


def compute_tv_regularization(loss, values, weight):
    """Sum-L1 TV along ray samples ([rays, samples, C]), accumulated into
    ``loss["loss"]``."""
    diffs = values[:, 1:, :] - values[:, :-1, :]
    tv = torch.sum(torch.abs(diffs))
    loss["loss"] = loss.get("loss", 0.0) + tv * weight
    return loss


def calc_fourier_loss(loss, x, y, lambda_sparsity=0.01, lambda_smoothness=0.01):
    """Fourier-magnitude reconstruction + sparsity + smoothness (the
    reconstruction term counted once)."""
    if x.ndim < 2 or y.ndim < 2:
        raise ValueError("Inputs must have at least 2 dimensions.")
    xa = torch.abs(torch.fft.fft2(x))
    ya = torch.abs(torch.fft.fft2(y))
    loss_sparsity = lambda_sparsity * torch.sum(xa)
    if xa.shape[-2] > 1 and xa.shape[-1] > 1:
        dx = xa[..., 1:, :] - xa[..., :-1, :]
        dy = xa[..., :, 1:] - xa[..., :, :-1]
        loss_smoothness = lambda_smoothness * (torch.abs(dx).mean()
                                               + torch.abs(dy).mean())
    else:
        loss_smoothness = torch.zeros((), dtype=xa.dtype, device=xa.device)
    loss_recon = torch.mean((xa - ya) ** 2)
    total = loss_recon + loss_sparsity + loss_smoothness
    loss["loss"] = loss.get("loss", 0.0) + total
    loss["loss_fourier_reconstruction"] = loss_recon
    loss["loss_sparsity"] = loss_sparsity
    loss["loss_smoothness"] = loss_smoothness
    return loss


def calc_fourier_sparsity_loss(loss, y, weight):
    """L1 sparsity of the centered Fourier coefficients."""
    if y.ndim < 2:
        raise ValueError("Input must have at least 2 dimensions.")
    fft_y = torch.fft.fftshift(torch.fft.fft2(y, dim=(-2, -1)))
    l = torch.mean(torch.abs(fft_y)) * weight
    loss["loss"] = loss.get("loss", 0.0) + l
    loss["loss_fourier_sparsity"] = l
    return loss


def calc_l1_loss(loss, x, y):
    """L1 loss."""
    l = torch.mean(torch.abs(x - y))
    loss["loss"] = loss.get("loss", 0.0) + l
    loss["loss_l1"] = l
    return loss



_PRIMARY_LOSSES = {
    # name -> (per-element loss(pred, target), component key)
    "mse": (lambda p, t: (t - p) ** 2, "loss_mse"),
    "l1": (lambda p, t: torch.abs(p - t), "loss_l1"),
    "huber": (
        lambda p, t: torch.where(
            torch.abs(p - t) <= 1.0, 0.5 * (p - t) ** 2, torch.abs(p - t) - 0.5
        ),
        "loss_huber",
    ),
    "hinge": (lambda p, t: torch.clamp(1 - p * t, min=0), "loss_hinge"),
    "phase": (lambda p, t: (_phase01(p) - _phase01(t)) ** 2, "phase_loss"),
}

_REGULARIZERS = ("small", "zero", "tv", "tvd")


def get_loss_fn(name: str = "mse", group=None):
    """Build the training loss named by ``cfg["train"]["loss"]``.

    Returns ``fn(pred, target, mask=None, aux=None) -> (loss, components)``
    where ``components`` maps loss-dict keys to scalars.  ``aux`` carries
    the renderer's ``tv_loss`` / ``tv_density``; "tvd" defaults to weight
    0.1, the others to 1, and "name:w" sets a weight.

    ``group`` (a ``torch.distributed`` process group; the sharded step's
    ``data`` group): every mean becomes the exact mean over the
    concatenated batch of the group's ranks -- numerator and denominator
    are each all-reduced before the division, so the value holds also
    when the mask sums differ per rank.  Each rank's autograd sees only
    its own share of the numerators (:func:`global_sum`; denominators
    take no gradient), so the ranks' gradients sum to the gradient of the
    global loss.  ``aux`` terms must already be global (the caller's
    job).  ``group=None`` is the single-process loss.
    """
    parts = [p.strip().lower() for p in str(name or "mse").split("+") if p.strip()]
    if not parts:
        parts = ["mse"]
    primary, reg_parts = parts[0], parts[1:]
    if primary in ("masked_mse", "mse_mask"):
        primary = "mse"  # masking is orthogonal (applied via the mask arg)
    if primary not in _PRIMARY_LOSSES:
        raise NotImplementedError(
            f"Unknown loss {primary!r}; choose from {sorted(_PRIMARY_LOSSES)}")
    regs = []
    for rp in reg_parts:
        r, _, wtxt = rp.partition(":")
        if r not in _REGULARIZERS:
            raise NotImplementedError(
                f"Unknown loss regularizer {r!r}; choose from {sorted(_REGULARIZERS)}")
        if wtxt:
            try:
                w = float(wtxt)
            except ValueError:
                raise ValueError(
                    f"Bad weight {wtxt!r} in loss regularizer {rp!r} "
                    f"(train.loss); expected e.g. '{r}:0.05'") from None
        else:
            w = 0.1 if r == "tvd" else 1.0
        regs.append((r, w))
    per_elem, comp_key = _PRIMARY_LOSSES[primary]
    mean = _gmean if group is None else (lambda x, mask=None: _global_mean(x, mask, group))

    def fn(pred, target, mask=None, aux=None):
        aux = aux or {}
        total = mean(per_elem(pred, target), mask)
        components = {comp_key: total}
        for r, w in regs:
            if r == "tv":
                term = aux.get("tv_loss", 0.0)
            elif r == "tvd":
                term = aux.get("tv_density", 0.0)
            elif r == "small":
                term = mean(pred ** 2)
            else:  # "zero"
                term = mean((torch.abs(target) <= 1e-5).to(pred.dtype) * pred ** 2)
            term = term * w
            components[f"loss_{r}"] = term
            total = total + term
        components["loss"] = total
        return total, components

    return fn
