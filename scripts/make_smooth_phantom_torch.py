#!/usr/bin/env python3
"""The smoothed chest phantom dataset, made on the card.

The chest phantom of ``data/chest_phantom.pickle`` has binary edges, so
PSNR against its ground truth measures sub-voxel sharpness more than
fidelity.  This makes the same anatomy low-passed at sigma = 1 voxel (the
sharpness class of real CT volumes) and reprojects its train and val views
with the port's projector (``data/projector.py::project_angles``) at the
same angles: the dataset of ``configs/chest_phantom_smooth.yaml``.

    python3 scripts/make_smooth_phantom_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.  :func:`smooth_phantom` does the work; ``main`` writes the file.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "data/chest_phantom.pickle"
OUT = "data/chest_phantom_smooth.pickle"
SIGMA = 1.0   # voxels


def smooth_phantom(base: Dict[str, Any], device=None, sigma: float = SIGMA) -> Dict[str, Any]:
    """``base`` with its image blurred by a ``sigma``-voxel Gaussian
    (``scipy.ndimage.gaussian_filter`` of the f32 image) and its train and
    val projections taken anew from that image at the same angles, on
    ``device`` (the card by default)."""
    import torch
    from scipy.ndimage import gaussian_filter

    from neuralvolumetricreconstructionformedicalimages_torch import geometry as G
    from neuralvolumetricreconstructionformedicalimages_torch.data.projector import (
        project_angles)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        resolve_device)

    img = gaussian_filter(np.asarray(base["image"], np.float32), sigma)
    vol = torch.as_tensor(img, device=resolve_device(device))
    geo = G.ConeGeometry.from_dict(base)
    out = dict(base)
    out["image"] = img
    for split in ("train", "val"):
        angles = np.asarray(base[split]["angles"], np.float32)
        out[split] = {"angles": base[split]["angles"],
                      "projections": project_angles(vol, geo, angles).cpu().numpy()}
    return out


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

    out = smooth_phantom(load_pickle(SRC), args.device)
    for split in ("train", "val"):
        projs = out[split]["projections"]
        print(f"{split} {projs.shape} range {projs.min():.6g} {projs.max():.6g}")
    save(out, OUT)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
