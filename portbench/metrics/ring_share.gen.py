"""The K/V ring's copy (the program's ``gen.ring`` spans: the
``torch.cat`` after each K3 chunk) as a share of the traced window (%):
the spans' event-timed device seconds over the window. None where the
program records no such span with device events."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    try:
        from transformer_gan_torch.utils import spans
    except ImportError:
        return None
    inside = [s for s in spans.recorded(t.lo, t.hi)
              if s.name == "gen.ring" and s.events is not None]
    if not inside:
        return None
    return 100.0 * spans.device_seconds(inside) / t.window_s
