"""The program's layer ranges, read for the per-layer metrics
``metrics/batch_sample_ms.py`` and the others of that family.

The program charges the device time of each layer range of its marked
training step to a sum on the device, which
``utils/profiling.py::range_totals()`` reads: ``{"steps", "device_ms":
{range: ms}, "hits": {range: intervals}}``, over the marked steps since
its graph last switched from plain to marked replays -- in a traced run,
the steps of the traced block.  A program without that function, or whose
marked steps are not the traced block's, gives None: the metric is then
left out of the line.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

PROFILING = "neuralvolumetricreconstructionformedicalimages_torch.utils.profiling"


def totals(ctx) -> Optional[Dict]:
    """The program's range totals for the traced block of ``ctx``, or None."""
    read = getattr(sys.modules.get(PROFILING), "range_totals", None)
    if read is None:
        return None
    t = read()
    if t["steps"] != ctx["trace"].steps:
        return None
    return t


def range_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Device ms a step of the ranges ``names`` together; None where the
    program has no such totals or no interval fell in them."""
    t = totals(ctx)
    if t is None or not any(t["hits"].get(n, 0) for n in names):
        return None
    return sum(t["device_ms"].get(n, 0.0) for n in names) / t["steps"]
