"""Config-driven loss selection (``cfg["train"]["loss"]``).

Port of the JAX ``losses.py::get_loss_fn`` registry.  ``train.loss`` names
a primary per-ray term, optionally composed with additive regularizers via
``+``, e.g. ``"mse"``, ``"huber"``, ``"mse+small"``, ``"l1+tvd:0.05"``.
Masking is a mask-weighted mean of the elementwise loss, the same estimator
as selecting the masked rays.  The single-loss calculators of the JAX
module are not ported yet (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

import math

import torch


def _phase01(x):
    return (torch.angle(x) + math.pi) / (2 * math.pi)


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


def _gmean(x, mask=None):
    if mask is None:
        return torch.mean(x)
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def get_loss_fn(name: str = "mse"):
    """Build the training loss named by ``cfg["train"]["loss"]``.

    Returns ``fn(pred, target, mask=None, aux=None) -> (loss, components)``
    where ``components`` maps loss-dict keys to scalars.  ``aux`` carries
    the renderer's ``tv_loss`` / ``tv_density``; "tvd" defaults to weight
    0.1, the others to 1, and "name:w" sets a weight.
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

    def fn(pred, target, mask=None, aux=None):
        aux = aux or {}
        total = _gmean(per_elem(pred, target), mask)
        components = {comp_key: total}
        for r, w in regs:
            if r == "tv":
                term = aux.get("tv_loss", 0.0)
            elif r == "tvd":
                term = aux.get("tv_density", 0.0)
            elif r == "small":
                term = _gmean(pred ** 2)
            else:  # "zero"
                term = _gmean((torch.abs(target) <= 1e-5).to(pred.dtype) * pred ** 2)
            term = term * w
            components[f"loss_{r}"] = term
            total = total + term
        components["loss"] = total
        return total, components

    return fn
