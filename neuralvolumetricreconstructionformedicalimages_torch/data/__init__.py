"""Data subsystem: pickle ingestion, device-resident ray sampling, the
forward projector, analytic phantoms, the synthetic generator and the
real-data formatter."""

from .dataset import (  # noqa: F401
    ProjectionDataset,
    gather_batch,
    gather_view_batch,
    load_dataset,
    load_pickle,
    make_dataset,
)
from .projector import project_angles, trilinear_sample  # noqa: F401
from .phantoms import PHANTOMS, get_phantom  # noqa: F401
from .generate import add_ct_noise, generate  # noqa: F401
from .format_real import format_real_data  # noqa: F401
