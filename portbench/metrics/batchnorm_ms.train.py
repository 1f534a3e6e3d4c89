"""Device ms per step in BatchNorm kernels (the "batch norm" kernel class),
from the profiled stretch."""


def read(ctx):
    st = ctx.stretch
    if ctx.kind != "train" or not st.units:
        return None
    return st.kind_us("batch norm") / 1e3 / st.units
