"""The whole frame's share of the card's bf16 peak: the FLOPs of the
convolutions and matmuls of one frame, counted by FlopCounterMode over the
plain reference at the cell's shapes, times the frames of the untraced
stretch, over its seconds and 989 TFLOP/s."""

from portbench.core.roofline import BF16_FLOPS


def read(ctx):
    if ctx.kind != "serve" or not ctx.flops_per_unit or not ctx.untraced_units:
        return None
    rate = ctx.flops_per_unit * ctx.untraced_units / ctx.untraced_seconds
    return 100.0 * rate / BF16_FLOPS
