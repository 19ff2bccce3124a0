"""Data subsystem: pickle ingestion and device-resident ray sampling.

Data generation, the forward projector and the real-data formatter are
not ported yet (ROADMAP.md, Queue 1 item 4)."""

from .dataset import (  # noqa: F401
    ProjectionDataset,
    gather_view_batch,
    load_dataset,
    load_pickle,
    make_dataset,
)
