"""YAML config system with recursive ``inherit_from`` deep-merge.

Port of the JAX ``config.py``: a config file may name a parent via
``inherit_from``; parents load first and children deep-merge on top.
Sections ``exp``, ``network``, ``encoder``, ``render``, ``train``, ``log``
and ``parallel`` (mesh shape, precision policy).
"""

from __future__ import annotations

import copy
import os.path as osp
from typing import Any, Dict, Optional

# Defaults for the knobs the reference-shaped configs leave out.
_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "parallel": {
        # e.g. {"data": 4, "sample": 2}: one rank a device (parallel/);
        # None = one process, the unsharded step.  ``force_mesh: true``
        # runs a mesh of one through the sharded step as well.
        "mesh": None,
        "compute_dtype": "float32",  # MLP matmul input dtype
        "table_dtype": "float32",    # rolled gather-table dtype
    },
    "encoder": {
        "hash_variant": "coherent",
        "fast": True,
        "backward": "bucket",
    },
    "train": {
        "seed": 42,
        "shuffle_views": False,
        "loss": "mse",
        "ray_mode": "auto",
    },
    "log": {
        "eval_mask": False,
    },
}


def update_recursive(dict1: Dict[str, Any], dict2: Dict[str, Any]) -> None:
    """Deep-merge ``dict2`` into ``dict1`` in place (dict2 wins on leaves)."""
    for k, v in dict2.items():
        if isinstance(v, dict):
            if not isinstance(dict1.get(k), dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def _read_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def load_config(path: str, default_path: Optional[str] = None) -> Dict[str, Any]:
    """Load a YAML config, resolving the ``inherit_from`` chain recursively.

    Relative ``inherit_from`` paths resolve against the child config's
    directory first, then against the working directory.
    """
    cfg_special = _read_yaml(path)
    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        parent = inherit_from
        if not osp.isabs(parent):
            cand = osp.join(osp.dirname(osp.abspath(path)), parent)
            parent = cand if osp.exists(cand) else parent
        cfg = load_config(parent, default_path)
    elif default_path is not None:
        cfg = _read_yaml(default_path)
    else:
        cfg = {}
    update_recursive(cfg, cfg_special)
    cfg.pop("inherit_from", None)
    return cfg


def with_defaults(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Return a copy of ``cfg`` with the defaults filled in."""
    out = copy.deepcopy(_DEFAULTS)
    update_recursive(out, cfg)
    return out
