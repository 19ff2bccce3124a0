"""Device ms a step of the encoder's PyTorch glue around its kernels
(ops/span_gather.py::_SortedEncode): the ranges ``encode.index`` (base indices,
in-cell positions, packing), ``encode.permute`` (positions to sorted order,
features back to point order) and ``backward.encode.permute`` (the gradient
to sorted order)."""

import layer_ranges


def read(ctx):
    return layer_ranges.range_ms(ctx, ("encode.index", "encode.permute", "backward.encode.permute"))
