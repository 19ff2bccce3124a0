"""Host ms a step of the program's epoch loop: the mean duration of its
``nvr.step`` host ranges (train/trainer.py::epoch_loop: setting the rate,
feeding the graph, the replay's launch, the loss copy) in the traced
block; None unless there is one a step, and where the block ran nothing
on a device (the loop's host side of a device it does not have)."""


def read(ctx):
    tr = ctx["trace"]
    us = [end - start for name, start, end in tr.host if name == "nvr.step"]
    if tr.window_s <= 0 or not us or len(us) != tr.steps:
        return None
    return sum(us) / 1e3 / tr.steps
