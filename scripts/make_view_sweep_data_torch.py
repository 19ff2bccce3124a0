#!/usr/bin/env python3
"""100- and 200-view variants of the bundled chest phantom, made on the card.

The same phantom volume, geometry and val split as
``data/chest_phantom.pickle``; only the number of evenly spaced training
views changes (``np.linspace(0, totalAngle, n + 1)[:-1] + startAngle``, in
radians, as f32), so that 3D and projection metrics compare across runs.
The train views are taken with the port's projector
(``data/projector.py::project_angles``) and the val split is copied.
Outputs, the datasets of ``configs/chest_phantom_views{100,200}(_b01).yaml``:

    data/chest_phantom_views100.pickle
    data/chest_phantom_views200.pickle

    python3 scripts/make_view_sweep_data_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.  At the end the 50 stored train views are reprojected and held to
:func:`check_reprojection`'s rule: the stored views came from an earlier
projector, which today's projectors (this one and the JAX package's) miss
at 24 pixels of views 16 and 34 by one boundary-voxel sample.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "data/chest_phantom.pickle"
VIEWS = (100, 200)
# The stored chest views that today's projectors miss, and at how many
# pixels in all: samples within an ulp of the edge of the in-volume band,
# where one program adds a boundary voxel's sample and the other not.
VIEWS_OFF, PIXELS_OFF = frozenset({16, 34}), 24


def out_path(n_views: int) -> str:
    return f"data/chest_phantom_views{n_views}.pickle"


def sweep_angles(base: Dict[str, Any], n_views: int) -> np.ndarray:
    """``n_views`` evenly spaced angles over ``totalAngle`` from
    ``startAngle`` (radians, f32, the endpoint dropped)."""
    total = base["totalAngle"] / 180.0 * np.pi
    start = base["startAngle"] / 180.0 * np.pi
    return (np.linspace(0, total, n_views + 1)[:-1] + start).astype(np.float32)


def project_views(base: Dict[str, Any], angles, device=None) -> np.ndarray:
    """Views of ``base``'s image at ``angles`` (radians), taken on
    ``device`` (the card by default)."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch import geometry as G
    from neuralvolumetricreconstructionformedicalimages_torch.data.projector import (
        project_angles)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        resolve_device)

    vol = torch.as_tensor(np.asarray(base["image"], np.float32),
                          device=resolve_device(device))
    return project_angles(vol, G.ConeGeometry.from_dict(base),
                          np.asarray(angles, np.float32)).cpu().numpy()


def view_sweep(base: Dict[str, Any], n_views: int, device=None) -> Dict[str, Any]:
    """``base`` with ``n_views`` train views of its image taken on
    ``device`` (the card by default); the val split is ``base``'s."""
    angles = sweep_angles(base, n_views)
    out = dict(base)
    out["numTrain"] = n_views
    out["train"] = {"angles": angles.astype(np.float64),
                    "projections": project_views(base, angles, device)}
    return out


def check_reprojection(base: Dict[str, Any], projections: np.ndarray) -> Dict[str, Any]:
    """Hold ``projections`` (the 50 train views of the chest phantom
    reprojected) against the stored ones: every pixel within 1e-6 but at
    most ``PIXELS_OFF``, all in ``VIEWS_OFF``, and those within one
    boundary-voxel sample (the image's largest value times the projector's
    sample spacing times the longest ray direction).  Returns the figures;
    raises ``AssertionError`` if the rule fails."""
    from neuralvolumetricreconstructionformedicalimages_torch import geometry as G

    geo = G.ConeGeometry.from_dict(base)
    stored = np.asarray(base["train"]["projections"])
    err = np.abs(np.asarray(projections) - stored)
    near, far = G.get_near_far(geo)
    n_samples = 2 * max(geo.nVoxel)
    d_max = float(G.rays_for_angle(geo, 0.0, "cpu")[1].norm(dim=-1).max())
    one_sample = float(np.max(base["image"])) * (far - near) / (n_samples - 1) * d_max
    over = err > 1e-6
    views_over = sorted(int(v) for v in np.nonzero(over.any(axis=(1, 2)))[0])
    res = dict(max_abs_err=float(err.max()), max_value=float(np.abs(stored).max()),
               pixels=int(err.size), pixels_over_1e6=int(over.sum()),
               views_over_1e6=views_over, samples=n_samples,
               one_sample_bound=one_sample)
    if not (set(views_over) <= VIEWS_OFF and over.sum() <= PIXELS_OFF
            and err.max() <= one_sample + 1e-6):
        raise AssertionError(f"the reprojected chest views differ from the stored "
                             f"ones beyond the known boundary samples: {res}")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device of the projector (default: cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import load_pickle
    from neuralvolumetricreconstructionformedicalimages_torch.data.generate import save

    base = load_pickle(SRC)
    for n_views in VIEWS:
        out = view_sweep(base, n_views, args.device)
        save(out, out_path(n_views))
        print(f"{out_path(n_views)}: train {out['train']['projections'].shape}, val "
              f"{out['val']['projections'].shape} (copied)", flush=True)
    res = check_reprojection(base, project_views(base, base["train"]["angles"],
                                                  args.device))
    print(f"reprojection check against the stored 50-view split: {res}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
