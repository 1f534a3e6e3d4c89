"""Device idle ms per step while the host is in the program's
`train.backward` spans (the main thread waits there while autograd's
device thread launches the backward): their intervals less the union of
the device operations inside them, over the profiled stretch."""

from portbench.core import spans

NAMES = ("train.backward",)


def read(ctx):
    if ctx.kind != "train":
        return None
    return spans.idle_ms_per_unit(ctx.stretch, NAMES)
