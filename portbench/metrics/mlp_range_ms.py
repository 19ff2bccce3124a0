"""Device ms a step of the MLP (models/density_field.py), forward and backward:
the ranges ``mlp`` and ``backward.mlp``, every kernel of its layers, skip concat,
activations and parameter gradients (``mlp_ms`` counts its GEMMs only)."""

import layer_ranges


def read(ctx):
    return layer_ranges.range_ms(ctx, ("mlp", "backward.mlp"))
