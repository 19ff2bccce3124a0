"""Real-measurement formatter: complex projection stacks -> reference-format pickle.

Port of the JAX package's ``data/format_real.py`` (NumPy there and here):
converts measured complex-valued laminography projections (npy) into the
training pickle -- rot90 about the detector axes, phase extraction via
``np.angle``, deg->rad angles, hand-specified parallel-beam geometry with
detector tilt, complex ``full_proj`` retained for beam masking.  The
number of angles is ``angles.size`` (the original formatter's
``angles.numel()`` fails on NumPy input).

CLI::

    python -m neuralvolumetricreconstructionformedicalimages_torch.data.format_real \\
        --projections proj.npy --angles angles_deg.npy --output scan.pickle \\
        [--tilt 29] [--slices 70]
"""

from __future__ import annotations

import argparse
import pickle
from typing import Any, Dict, Optional

import numpy as np


def format_real_data(
    projections: np.ndarray,
    angles_deg: np.ndarray,
    *,
    DSD: float = 1500.0,
    DSO: float = 1000.0,
    dDetector=(1.0, 1.0),
    n_slices: int = 70,
    tilt_angle: float = 29.0,
    rot90_k: int = 1,
    image: Optional[np.ndarray] = None,
) -> Dict[str, Any]:
    """Build the dataset dict."""
    projections = np.asarray(projections)
    projections = np.rot90(projections, k=rot90_k, axes=(1, 2))
    phase = np.angle(projections).astype(np.float32)

    angles_rad = np.deg2rad(np.asarray(angles_deg, np.float64))
    num_angles = int(angles_rad.size)
    H, W = phase.shape[1], phase.shape[2]

    return {
        "numTrain": num_angles,
        "numVal": num_angles,
        "DSD": DSD,
        "DSO": DSO,
        "nDetector": [W, H],
        "dDetector": list(dDetector),
        "nVoxel": [W, W, n_slices],
        "dVoxel": [1, 1, 1],
        "offOrigin": [-W, -W, -n_slices],
        "offDetector": [0, 0],
        "accuracy": 0.5,
        "mode": "parallel",
        "filter": None,
        "totalAngle": 360,
        "startAngle": 0,
        "randomAngle": False,
        "convert": False,
        "rescale_slope": 1.0,
        "rescale_intercept": 0.0,
        "normalize": True,
        "noise": 0,
        "tilt_angle": tilt_angle,
        "image": image if image is not None else np.zeros((W, W, n_slices), np.float32),
        "full_proj": projections,
        "train": {"angles": angles_rad, "projections": phase},
        "val": {"angles": angles_rad, "projections": phase},
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--projections", required=True, help="npy of complex projections [N, H, W]")
    p.add_argument("--angles", required=True, help="npy of angles in degrees [N]")
    p.add_argument("--output", required=True, help="output pickle path")
    p.add_argument("--tilt", type=float, default=29.0)
    p.add_argument("--slices", type=int, default=70)
    args = p.parse_args(argv)

    projections = np.load(args.projections)
    angles = np.load(args.angles)
    data = format_real_data(projections, angles,
                            tilt_angle=args.tilt, n_slices=args.slices)
    with open(args.output, "wb") as f:
        pickle.dump(data, f, pickle.HIGHEST_PROTOCOL)
    print(f"Saved {args.output}")


if __name__ == "__main__":
    main()
