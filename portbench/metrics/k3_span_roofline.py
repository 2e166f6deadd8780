"""K3's share of its roofline (%) on the program's own ``k3`` spans: the
least time of the window's K3 calls (``work.sampler_work`` a chunk, as
``k3_roofline``) over the spans' event-timed device seconds, in which the
chain's kernels that overlap under programmatic dependent launch count
once. None unless the window's spans are as many as its
``generate_chunk`` launches, and those as its waves' chunks."""
from portbench import work

NAME = "k3"
COUNTER = "generate_chunk"


def read(ctx):
    calls = ctx.launches.get(COUNTER, 0)
    if ctx.trace is None or not calls or calls != ctx.waves * len(ctx.chunks):
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
    least = sum(work.bound_ms(*work.sampler_work(
        n, s["B"], s["M"], count, L=s["L"], HD=s["HD"], DI=s["DI"],
        V=s["V"])) for n, count in ctx.chunks) * 1e-3
    return 100.0 * ctx.waves * least / seconds
