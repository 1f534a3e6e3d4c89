"""The lift's backward's share of its bytes roofline in training: the
least time its bytes take at 3.35 TB/s (`roofline.lift_backward_bytes`,
from the cell's shapes) over the device time of the kernels launched under
the `occdepth::flosp_stereo_lift_backward` operator."""

from portbench.core.roofline import share_pct

OPS = ("occdepth::flosp_stereo_lift_backward",)


def read(ctx):
    st = ctx.stretch
    us = sum(st.op_device_us.get(op, 0.0) for op in OPS)
    if ctx.kind != "train" or us <= 0:
        return None
    calls = st.units * ctx.lift_calls_per_unit
    return share_pct(ctx.lift_bwd_bytes_per_call * calls, us / 1e6)
