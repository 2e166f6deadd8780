"""Device kernels launched in the traced window per generated token."""


def read(ctx):
    if ctx.trace is None or not ctx.tokens or not ctx.trace.kernels:
        return None
    return ctx.trace.kernels / ctx.tokens
