"""100 x (1 - union of the device operations' intervals / the profiled
stretch), the share of the stretch in which the device ran nothing."""


def read(ctx):
    st = ctx.stretch
    if ctx.kind != "train" or st.window_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
