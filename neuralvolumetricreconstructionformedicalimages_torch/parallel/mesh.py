"""Device-mesh construction and multi-process bring-up on ``torch.distributed``.

Port of the JAX ``parallel/mesh.py``.  One process drives one device
(a rank); the ranks of the default process group form a named 2-D mesh:

- ``"data"``: rays are sharded over this axis (data parallelism).  The
  field's parameters stay replicated; gradients are all-reduced over the
  whole mesh inside the sharded step (``parallel/step.py``).
- ``"sample"``: an optional split of each ray's depth samples: every rank
  of a sample group holds the same rays, integrates a contiguous z-range
  and the partial line integrals are all-reduced.

Rank ``r`` sits at ``(r // sample, r % sample)``, the layout of JAX's
``reshape(data, sample)``.  Launch one process a device, e.g.
``torchrun --nproc-per-node 4 -m ...train.cli --config ...``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"
# A collective that waits longer than this fails instead of hanging.
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Static mesh description, constructible from the ``parallel.mesh``
    config section (e.g. ``{"data": 4, "sample": 2}``)."""

    data: int = 1
    sample: int = 1

    @classmethod
    def from_config(cls, mesh_cfg: Optional[Dict[str, int]]) -> "MeshSpec":
        if not mesh_cfg:
            return cls()
        return cls(
            data=int(mesh_cfg.get(DATA_AXIS, 1)),
            sample=int(mesh_cfg.get(SAMPLE_AXIS, 1)),
        )

    @property
    def n_devices(self) -> int:
        return self.data * self.sample

    @property
    def axis_names(self) -> Sequence[str]:
        return (DATA_AXIS, SAMPLE_AXIS)


def make_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """The named 2-D ``DeviceMesh`` ``(data, sample)`` over the ranks of the
    default process group, which must hold exactly ``spec.n_devices``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {spec} needs a process group: call initialize_multihost() "
            f"or launch with torchrun --nproc-per-node {spec.n_devices}")
    n, world = spec.n_devices, dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {spec} needs {n} devices, {world} available "
                         f"(one a rank of the process group)")
    layout = torch.arange(n).reshape(spec.data, spec.sample)
    return DeviceMesh(device_type, layout, mesh_dim_names=tuple(spec.axis_names))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group``.

    With ``coordinator_address`` (``"host:port"``) the group meets there
    over ``tcp://``, with ``num_processes`` ranks of which this is
    ``process_id``; under ``torchrun`` it reads its environment
    (``env://``).  With neither, this is a single process and nothing is
    done.  Idempotent.

    ``backend`` defaults to ``"nccl"`` when ``device`` (default: the card)
    is a CUDA device and to ``"gloo"`` on the CPU; it is never switched
    afterwards.  A CUDA process is bound to ``cuda:(LOCAL_RANK %
    device_count)`` first.
    """
    if dist.is_initialized():
        return
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if coordinator_address is None and not torchrun:
        return
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=int(process_id))
        local = int(process_id)
    else:
        kwargs.update(init_method="env://")
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run the group on the CPU")
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kwargs)


def local_batch_size(total: int, mesh, axis: str = DATA_AXIS) -> int:
    """Per-shard batch size; ``total`` must divide evenly (static shapes)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if total % n != 0:
        raise ValueError(f"batch size {total} not divisible by mesh axis {axis}={n}")
    return total // n
