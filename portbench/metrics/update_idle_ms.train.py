"""Device idle ms per step while the host is in the program's
`train.confusion` or `train.update` spans (the confusion counts; the
zero-fill, clip and AdamW): their intervals less the union of the device
operations inside them, over the profiled stretch."""

from portbench.core import spans

NAMES = ("train.confusion", "train.update")


def read(ctx):
    if ctx.kind != "train":
        return None
    return spans.idle_ms_per_unit(ctx.stretch, NAMES)
