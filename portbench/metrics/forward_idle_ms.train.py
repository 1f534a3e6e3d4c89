"""Device idle ms per step while the host is in the program's
`train.forward` or `train.losses` spans: their intervals less the union of
the device operations inside them, over the profiled stretch."""

from portbench.core import spans

NAMES = ("train.forward", "train.losses")


def read(ctx):
    if ctx.kind != "train":
        return None
    return spans.idle_ms_per_unit(ctx.stretch, NAMES)
