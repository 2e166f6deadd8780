"""Tokens of the window's work over the window on the host clock, the
window opened and closed on a device synchronize (summed over cards)."""


def read(ctx):
    if not ctx.tokens or ctx.window_s <= 0:
        return None
    return ctx.tokens / ctx.window_s
