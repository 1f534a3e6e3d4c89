"""The fused lift's share of its bytes roofline in serving: the least time
its bytes take at 3.35 TB/s (`roofline.lift_bytes`, from the cell's
shapes) over the device time of the kernels launched under the
`occdepth::flosp_stereo_lift` and `occdepth::pack_map` operators."""

from portbench.core.roofline import share_pct

OPS = ("occdepth::flosp_stereo_lift", "occdepth::pack_map")


def read(ctx):
    st = ctx.stretch
    us = sum(st.op_device_us.get(op, 0.0) for op in OPS)
    if ctx.kind != "serve" or us <= 0:
        return None
    calls = st.units * ctx.lift_calls_per_unit
    return share_pct(ctx.lift_fwd_bytes_per_call * calls, us / 1e6)
