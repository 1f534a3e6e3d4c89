"""Host ms per dispatch: the pipeline's upload and forward enqueue, timed
by the harness around the two calls, mean over the untraced stretch."""


def read(ctx):
    spans = ctx.dispatch_host_ms
    if ctx.kind != "serve" or not spans:
        return None
    return sum(spans) / len(spans)
