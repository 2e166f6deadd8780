"""K1b's share of its roofline (%) on the program's own ``k1b`` spans (on
the autograd engine's thread): the least time of the window's calls
(``work.attention_work`` backward at the cell's shapes, memory full, as
``k1b_roofline``) over the spans' event-timed device seconds. None unless
the window's spans are as many as its ``xl_attn_bwd_v2`` launches.

The denominator runs from the event the wrapper records on entry to the one
it records on exit, so it holds the wrapper's small ops (the fp32 casts of
its inputs, reset rows) and, where the device waits for the host, the device's
idle while the host is still inside the wrapper: the share moves with host
work even where K1b does not. ``k1b_roofline`` is the kernel-only reading
(the device time of the kernels its name matches)."""
from portbench import work

NAME = "k1b"
COUNTER = "xl_attn_bwd_v2"


def read(ctx):
    calls = ctx.launches.get(COUNTER, 0)
    if ctx.trace is None or not calls:
        return None
    try:
        from transformer_gan_torch.utils import spans
    except ImportError:
        return None
    inside = [s for s in spans.recorded(ctx.trace.lo, ctx.trace.hi)
              if s.name == NAME]
    if len(inside) != calls:
        return None
    seconds = spans.device_seconds(inside)
    if seconds <= 0:
        return None
    s = ctx.shapes
    nbytes, flops = work.attention_work(s["q"], s["B"], s["M"], s["M"],
                                        backward=True, H=s["H"], dh=s["dh"])
    return 100.0 * calls * work.bound_ms(nbytes, flops) * 1e-3 / seconds
