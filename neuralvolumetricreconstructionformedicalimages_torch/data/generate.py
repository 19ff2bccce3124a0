"""Synthetic dataset generator: phantom/CT volume -> reference-format pickle.

Port of the JAX package's ``data/generate.py``; only the projection runs
on the card (``projector.project_angles``), the rest stays NumPy/SciPy on
the host, as there:

- volume source: an ``img.mat`` CT file or a built-in analytic phantom;
- optional HU -> attenuation conversion ``mu = 0.206 + (mu_w - mu_a)/1000 * HU``;
- cubic-spline resample to ``nVoxel`` + [0, 1] normalization;
- evenly spaced or random train angles over ``totalAngle`` starting at
  ``startAngle``; random val angles over 180 deg, drawn from
  ``np.random.default_rng(seed)`` in the JAX package's order;
- optional CT noise: Poisson photon statistics (I0 = 1e5) + Gaussian
  electronic noise;
- the pickle schema of the JAX package, so a dataset written by either
  package loads in the other's ``load_pickle``.

CLI (on the card unless ``--device cpu``)::

    python -m neuralvolumetricreconstructionformedicalimages_torch.data.generate \\
        --phantom lamino_chip --config <scan.yaml> [--outputName NAME] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
from typing import Any, Dict, Optional

import numpy as np

from .. import geometry as G
from .phantoms import get_phantom
from .projector import project_angles

# Default acquisition config (the JAX package's ``DEFAULT_SCAN``).
DEFAULT_SCAN: Dict[str, Any] = {
    "DSD": 1500.0,          # mm
    "DSO": 1000.0,          # mm
    "nDetector": [256, 256],
    "dDetector": [1.0, 1.0],
    "nVoxel": [128, 128, 128],
    "dVoxel": [1.0, 1.0, 1.0],
    "offOrigin": [0, 0, 0],
    "offDetector": [0, 0],
    "accuracy": 0.5,
    "mode": "cone",
    "filter": None,
    "totalAngle": 180,
    "startAngle": 0,
    "randomAngle": False,
    "numTrain": 50,
    "numVal": 50,
    "convert": False,
    "rescale_slope": 1.0,
    "rescale_intercept": 0.0,
    "normalize": True,
    "noise": 0,
    "tilt_angle": 0,
}


def convert_to_attenuation(data: np.ndarray, rescale_slope: float,
                           rescale_intercept: float) -> np.ndarray:
    """HU -> linear attenuation."""
    HU = data * rescale_slope + rescale_intercept
    mu_water, mu_air = 0.206, 0.0004
    return mu_water + (mu_water - mu_air) / 1000.0 * HU


def load_volume(path: Optional[str], scan: Dict[str, Any],
                phantom: Optional[str] = None) -> np.ndarray:
    """Load + preprocess the volume: mat file or analytic phantom, optional
    HU conversion, resample, normalize."""
    nVoxel = tuple(int(v) for v in scan["nVoxel"])
    if phantom is not None:
        image = get_phantom(phantom, nVoxel)
    else:
        import scipy.io

        image = scipy.io.loadmat(path)["img"].astype(np.float32)
        if scan.get("convert"):
            image = convert_to_attenuation(
                image, scan["rescale_slope"], scan["rescale_intercept"])
    if image.shape != nVoxel:
        import scipy.ndimage

        zoom = [n / s for n, s in zip(nVoxel, image.shape)]
        image = scipy.ndimage.zoom(image, zoom, order=3, prefilter=False)
    lo, hi = float(image.min()), float(image.max())
    if scan.get("normalize", True) and lo != 0 and hi != 1 and hi > lo:
        image = (image - lo) / (hi - lo)
    return image.astype(np.float32)


def add_ct_noise(projections: np.ndarray, poisson: float = 1e5,
                 gaussian=(0.0, 10.0), seed: int = 0) -> np.ndarray:
    """Photon-statistics CT noise (as TIGRE's ``CTnoise.add``):
    counts = Poisson(I0 * exp(-p)) + N(mu, sigma); p' = -log(counts / I0)."""
    rng = np.random.default_rng(seed)
    i0 = float(poisson)
    counts = rng.poisson(i0 * np.exp(-projections)).astype(np.float64)
    counts = counts + rng.normal(gaussian[0], gaussian[1], projections.shape)
    counts = np.maximum(counts, 1.0)
    noisy = -np.log(counts / i0)
    return np.maximum(noisy, 0.0).astype(np.float32)


def generate(scan: Dict[str, Any], *, mat_path: Optional[str] = None,
             phantom: Optional[str] = None, seed: int = 0,
             proj_samples: int = 0, device=None) -> Dict[str, Any]:
    """Produce a reference-format dataset dict; the projections are taken
    on ``device`` (the card by default)."""
    data = dict(DEFAULT_SCAN)
    data.update(scan)
    rng = np.random.default_rng(seed)

    image = load_volume(mat_path, data, phantom)
    data["image"] = image.copy()

    geo = G.ConeGeometry.from_dict(data)
    start = data["startAngle"] / 180.0 * np.pi
    total = data["totalAngle"] / 180.0 * np.pi
    if not data["randomAngle"]:
        train_angles = np.linspace(0, total, data["numTrain"] + 1)[:-1] + start
    else:
        train_angles = np.sort(rng.random(data["numTrain"]) * total) + start
    val_angles = np.sort(rng.random(data["numVal"]) * np.pi) + start

    train_projs = project_angles(image, geo, train_angles.astype(np.float32),
                                 proj_samples, device).cpu().numpy()
    val_projs = project_angles(image, geo, val_angles.astype(np.float32),
                               proj_samples, device).cpu().numpy()

    if data.get("noise") and data.get("normalize", True):
        train_projs = add_ct_noise(train_projs, 1e5, (0.0, 10.0), seed)
        val_projs = add_ct_noise(val_projs, 1e5, (0.0, float(data["noise"])), seed + 1)

    data["train"] = {"angles": train_angles, "projections": train_projs}
    data["val"] = {"angles": val_angles, "projections": val_projs}
    return data


def save(data: Dict[str, Any], output_path: str) -> None:
    d = osp.dirname(output_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(output_path, "wb") as handle:
        pickle.dump(data, handle, pickle.HIGHEST_PROTOCOL)


def main(argv=None):
    """The generator's command line (the JAX package's, plus ``--device``)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ctName", default=None, help="CT volume name (expects <dataFolder>/<ctName>/img.mat + config.yml)")
    p.add_argument("--phantom", default=None, choices=["shepp_logan", "ball", "cubes", "lamino_chip"],
                   help="built-in analytic phantom instead of img.mat")
    p.add_argument("--outputName", default="dataset")
    p.add_argument("--dataFolder", default="raw")
    p.add_argument("--outputFolder", default="./data")
    p.add_argument("--config", default=None, help="YAML scan config (optional for phantoms)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device of the projector (default: cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)

    scan: Dict[str, Any] = {}
    mat_path = None
    if args.ctName is not None:
        mat_path = osp.join(args.dataFolder, args.ctName, "img.mat")
        cfg_path = args.config or osp.join(args.dataFolder, args.ctName, "config.yml")
        import yaml

        with open(cfg_path) as f:
            scan = yaml.safe_load(f)
    elif args.config is not None:
        import yaml

        with open(args.config) as f:
            scan = yaml.safe_load(f)
    elif args.phantom is None:
        p.error("need --ctName or --phantom")

    data = generate(scan, mat_path=mat_path, phantom=args.phantom, seed=args.seed,
                    device=args.device)
    out = osp.join(args.outputFolder, f"{args.outputName}.pickle")
    save(data, out)
    print(f"Save files in {out}")


if __name__ == "__main__":
    main()
