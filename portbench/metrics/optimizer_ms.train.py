"""Device ms per step in the clip and AdamW kernels (the "optimizer" kernel
class), from the profiled stretch."""


def read(ctx):
    st = ctx.stretch
    if ctx.kind != "train" or not st.units:
        return None
    return st.kind_us("optimizer") / 1e3 / st.units
