"""Share (%) of the XOR hash encoder's time a step that its least time
takes: ``counts.least_seconds`` of the encoder's work
(``counts.hash_encoder_work``, the yardstick of ``hash_kernels_roofline``,
whatever implements the encoder) over the device time of the four ranges
of its forward and backward.  None unless each of the four ran."""

import counts
import layer_ranges

RANGES = ("encode.index", "encode.gather", "backward.encode.sort", "backward.encode.bucket")


def read(ctx):
    t = layer_ranges.totals(ctx)
    work = ctx["work"].get("hash_encoder")
    if t is None or work is None or not all(t["hits"].get(n, 0) for n in RANGES):
        return None
    seconds = sum(t["device_ms"][n] for n in RANGES) * 1e-3 / t["steps"]
    return 100.0 * counts.least_seconds(work) / seconds
