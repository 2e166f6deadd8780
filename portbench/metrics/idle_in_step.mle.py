"""Device idle time inside the program's ``train.step`` spans (the main thread
enqueuing the MLE step, K1f's spans and the optimizer within), as a share of
the traced window (%): the window less the trace's busy intervals, laid
against the spans' host intervals (``span_idle``). None where the program
records no such span."""

NAMES = ("train.step",)


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    try:
        from transformer_gan_torch.utils import spans
    except ImportError:
        return None
    inside = [s for s in spans.recorded(t.lo, t.hi)
              if s.name in NAMES and s.thread == spans.MAIN]
    if not inside:
        return None
    from portbench.metrics import span_idle
    return 100.0 * span_idle.idle_in(t, inside) / t.window_s
