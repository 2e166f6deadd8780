"""Share of the traced window in which no operation ran on the device (%):
1 - the union of the device's busy intervals over the window."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.merged:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
