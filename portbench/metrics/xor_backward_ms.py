"""Device ms a step of the XOR hash encoder's backward
(ops/hash_encoding.py::_HashEncodeFast.backward): the ranges
``backward.encode.sort`` (the corner stream's stable key sort and the
payload's gather) and ``backward.encode.bucket`` (the bucket kernel at D=0
and the gradient's transpose)."""

import layer_ranges


def read(ctx):
    return layer_ranges.range_ms(ctx, ("backward.encode.sort", "backward.encode.bucket"))
