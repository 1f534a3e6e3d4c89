"""Device ms per frame from the entry to the exit event of the program's
`model.backbone_2d` spans (each 2D UNet call, both views at once in
serving), over the profiled stretch: the stage's work and any device idle
inside it."""

from portbench.core import spans


def read(ctx):
    if ctx.kind != "serve":
        return None
    return spans.device_ms_per_unit(ctx.stretch, "model.backbone_2d")
