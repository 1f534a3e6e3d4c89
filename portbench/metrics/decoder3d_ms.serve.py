"""Device ms per frame from the entry to the exit event of the program's
`model.decoder_3d` spans (the whole 3D UNet, the CRP and the heads
included), over the profiled stretch: the stage's work and any device
idle inside it."""

from portbench.core import spans


def read(ctx):
    if ctx.kind != "serve":
        return None
    return spans.device_ms_per_unit(ctx.stretch, "model.decoder_3d")
