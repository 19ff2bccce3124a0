"""Device ms a step of the renderer and the loss, forward and backward: the
ranges ``render`` (render.py, ops/integration.py: integration, TV terms),
``loss`` (train/trainer.py::make_loss_fn) and ``backward.render``."""

import layer_ranges


def read(ctx):
    return layer_ranges.range_ms(ctx, ("render", "loss", "backward.render"))
