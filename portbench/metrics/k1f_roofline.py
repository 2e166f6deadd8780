"""K1f's share of its roofline (%): the least time of its calls in the
window (``work.attention_work`` at the cell's shapes, memory full) over the
device time of its kernels in the trace."""
from portbench import work

# the bf16 kernel of csrc/attention_v2_tc.cu (the only attention forward
# that runs where every step has memory)
PATTERN = r"xl_attn_fwd"
COUNTER = "xl_attn_fwd_v2"


def read(ctx):
    calls = ctx.launches.get(COUNTER, 0)
    if ctx.trace is None or not calls:
        return None
    seconds = ctx.trace.op_seconds(PATTERN)
    if seconds <= 0:
        return None
    s = ctx.shapes
    nbytes, flops = work.attention_work(s["q"], s["B"], s["M"], s["M"],
                                        H=s["H"], dh=s["dh"])
    return 100.0 * calls * work.bound_ms(nbytes, flops) * 1e-3 / seconds
