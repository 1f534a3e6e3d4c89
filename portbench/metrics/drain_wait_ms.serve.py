"""Host ms per dispatch in the pipeline's blocking readout of a batch's
class grids (the program's `serve.drain` spans, one a dispatch), over the
profiled stretch."""

from portbench.core import spans


def read(ctx):
    if ctx.kind != "serve":
        return None
    return spans.host_ms_per(ctx.stretch, "serve.drain", "serve.dispatch")
