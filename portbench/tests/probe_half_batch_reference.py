"""A configuration's own plain reference, for the tests of
``run.load_reference``: ``reference.py``'s, except that its readings leave
half of the batch out of the loss and take the mean over the rest, so
that a sound run judged by it is not correct."""

import reference
from reference import corner_rows, layer_dims, make_scan, make_weights  # noqa: F401


def reference_readings(cfg, proj, weights, draws, views, *, steps, steps_per_epoch,
                       tf32=False, keep=1.0, points=None):
    return reference.reference_readings(cfg, proj, weights, draws, views, steps=steps,
                                        steps_per_epoch=steps_per_epoch, tf32=tf32,
                                        keep=0.5 * keep, points=points)
