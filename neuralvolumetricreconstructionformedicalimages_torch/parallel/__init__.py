"""Multi-device parallelism on ``torch.distributed``.

Port of the JAX package's ``parallel/``: a named ``(data, sample)`` mesh of
ranks (one process a device, ``torch.distributed.device_mesh``), sharded
training steps whose losses are exact global means and whose gradient is
one all-reduce of the true gradient, and the process-group bring-up
(``torchrun`` or an explicit coordinator).
"""

from .mesh import MeshSpec, initialize_multihost, local_batch_size, make_mesh
from .step import make_sharded_epoch_fn, make_sharded_train_step

__all__ = [
    "MeshSpec",
    "make_mesh",
    "initialize_multihost",
    "local_batch_size",
    "make_sharded_train_step",
    "make_sharded_epoch_fn",
]
