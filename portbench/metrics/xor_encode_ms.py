"""Device ms a step of the XOR hash encoder's forward
(ops/hash_encoding.py::_he_forward): the ranges ``encode.index`` (corners,
trilinear weights, the dense or hashed rows) and ``encode.gather`` (the
table gather and the weighted corner sum)."""

import layer_ranges


def read(ctx):
    return layer_ranges.range_ms(ctx, ("encode.index", "encode.gather"))
