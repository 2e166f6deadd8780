"""Forward operations of the window's generated tokens (from the shapes)
over window x cards x the bf16 peak (%)."""
from portbench import work


def read(ctx):
    if ctx.trace is None or not ctx.flops or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.flops / (ctx.window_s * ctx.chips
                                * work.PEAK_FLOPS["bfloat16"])
