"""Device ms a step of the layer ranges ``batch`` (data/dataset.py::gather_batch:
pixels, projections, rays) and ``sample`` (render.py, ops/sampling.py: depths,
points, the scaling to the unit cube)."""

import layer_ranges


def read(ctx):
    return layer_ranges.range_ms(ctx, ("batch", "sample"))
