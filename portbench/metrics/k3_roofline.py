"""K3's share of its roofline (%): the least time of the window's K3 calls
(``work.sampler_work`` a chunk, with the ring's count at the chunk) over the
device time of the bf16 decode chain's kernels in the trace."""
from portbench import work

# the kernels of csrc/decode_chain_tc.cuh and the sampling epilogue of
# csrc/generate.cu
PATTERN = (r"tc_gemv|split_attn|split_combine|sample_kernel|decode_attn"
           r"|gemv_rows|gemv_kernel")
COUNTER = "generate_chunk"


def read(ctx):
    calls = ctx.launches.get(COUNTER, 0)
    if ctx.trace is None or not calls or calls != ctx.waves * len(ctx.chunks):
        return None
    seconds = ctx.trace.op_seconds(PATTERN)
    if seconds <= 0:
        return None
    s = ctx.shapes
    least = sum(work.bound_ms(*work.sampler_work(
        n, s["B"], s["M"], count, L=s["L"], HD=s["HD"], DI=s["DI"],
        V=s["V"])) for n, count in ctx.chunks) * 1e-3
    return 100.0 * ctx.waves * least / seconds
