"""Device ms a step between the steps: the range ``step.io``, from one step's
end mark to the next step's first (input copies into the graph, the loss
copy, the rate's fill, and any time the device waited for the host)."""

import layer_ranges


def read(ctx):
    return layer_ranges.range_ms(ctx, ("step.io",))
