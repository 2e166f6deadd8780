"""K1b's share of its roofline (%): the least time of its calls in the
window (``work.attention_work`` backward at the cell's shapes, memory full)
over the device time of its kernels in the trace."""
from portbench import work

# the bf16 kernels of csrc/attention_v2_tc_bwd.cu (rows, keys, position
# gradient) and the position gradient's reduction
PATTERN = r"xl_attn_bwd"
COUNTER = "xl_attn_bwd_v2"


def read(ctx):
    calls = ctx.launches.get(COUNTER, 0)
    if ctx.trace is None or not calls:
        return None
    seconds = ctx.trace.op_seconds(PATTERN)
    if seconds <= 0:
        return None
    s = ctx.shapes
    nbytes, flops = work.attention_work(s["q"], s["B"], s["M"], s["M"],
                                        backward=True, H=s["H"], dh=s["dh"])
    return 100.0 * calls * work.bound_ms(nbytes, flops) * 1e-3 / seconds
