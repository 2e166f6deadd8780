"""Device-time breakdown of the decode-chain kernels on one CUDA card.

    python -m transformer_gan_torch.profile_generate [--lanes 1 8] [--mem 4146] [--ablate]

One 32-token call of each fused sampler at the baseline model's full width
in bf16 on a full ring is traced with ``torch.profiler``: the generation
sampler (K3) for each lane count at M ``--mem``, and the GAN's gumbel
sampler (K4) at its op-point, B 64, M 64. The script prints each CUDA
kernel's launches and device milliseconds, their total, and from that one
traced call: the busy time (the union of the kernels' device intervals:
the bf16 chain's kernels overlap under programmatic dependent launch, so
their summed device time can exceed it), the span from the first kernel's
start to the last one's end, the call's time from CUDA events recorded
around it inside the trace, the busy share of the span (the gaps between
kernels) and of the call (the host's set-up before the first kernel
included), and the kernel launches a token (every launch of the traced
call over its 32 tokens, the wrapper's few per-call kernels included). The
untraced call's time (CUDA events) is printed beside them. Then the plain
version of the XL attention forward (K1f) at q 128, B 1 is broken down the
same way.

``--ablate`` rebuilds the kernel library from an edited copy of ``csrc/``
(under ``build/profile_generate/``; the sources are not touched) with the
LayerNorm taken out of the bf16 GEMVs' prologue (the rows are copied and
multiplied unnormalized), or parts of the lane-grouped decode attention
taken out (``ABLATIONS``: the whole kernel, its compute, its loads, its
merge; they act where K3 takes lane groups, B >= 8), and times K3 and K4 at
the op-points above against the unedited sources built the same way (CUDA
events): the edited results are wrong, only the times mean something. What
a removal saves is an upper bound on what the part costs.
Weights and cache are seeded random; their values do not change the work
done.
"""
from __future__ import annotations

import argparse
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from . import kernel_check as kc
from .utils import spans

# host-side ops and copies that the trace also lists with a device time
_NOT_KERNELS = ("aten::", "Activity Buffer", "Memcpy", "Memset")
N_TOKENS = 32

# part of the bf16 chain taken out -> (file, text, replacement) edits of the
# sources (``--ablate``): the GEMVs' LayerNorm prologue, and parts of the
# lane-grouped decode attention (grouped_split_attn_kernel, at B >= 8 where
# the keys are split): the whole kernel, its scoring and P V (loads only),
# its K / V / R loads (compute only), and the last block's merge
_TC = "decode_chain_tc.cuh"
ABLATIONS = {
    "layernorm prologue": [(_TC,
                            "  if (in.ln_s != nullptr) {\n    const float2* sc2",
                            "  if (false) {\n    const float2* sc2")],
    "grouped attention": [(_TC,
                           "  // before the wait: the first stages' big-cache "
                           "and R rows\n",
                           "  pdl_wait();\n  pdl_trigger();\n  return;\n")],
    "grouped compute": [(_TC,
                         "    if (!active) continue;\n"
                         "    const GroupRows r = lane_rows(i);",
                         "    continue;\n    const GroupRows r = lane_rows(i);")],
    "grouped loads": [(_TC, "  auto issue = [&](int i, int part) {\n",
                       "  auto issue = [&](int i, int part) {\n    return;\n")],
    "grouped merge": [(_TC, "  if (*last == 0 || !active) return;\n",
                       "  return;\n")],
}


def _is_kernel(name: str) -> bool:
    """Whether a device row or event of the trace is a kernel: not a host
    op, copy or profiler buffer, and not the device-side copy of a span's
    range (``utils/spans.NAMES``), which covers the kernels it encloses."""
    return name not in spans.NAMES and not any(k in name for k in _NOT_KERNELS)


def _device_rows(prof) -> list:
    """(name, count, device ms) of the trace's device-side rows: a host-side
    row (an op, a runtime call) may carry its children's device time too."""
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", 0)
        if (dt > 0 and e.count > 0
                and e.device_type == torch.autograd.DeviceType.CUDA):
            rows.append((e.key, e.count, dt / 1000.0))
    return sorted(rows, key=lambda r: -r[2])


def _busy_ms(prof) -> tuple[float, float]:
    """(busy, span) in milliseconds: the time in which at least one kernel
    of the trace ran, and the time from the first kernel's start to the
    last kernel's end."""
    spans = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and _is_kernel(e.name()))
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6, (end - spans[0][0]) / 1e6


def _case(kernel: str, B: int, M: int):
    return (kc.GenerateCase("bfloat16", B, M, M=M) if kernel == "K3"
            else kc.DecodeCase("bfloat16", B, M, M=M))


def profile_chunk(kernel: str, B: int, M: int, top: int = 12) -> dict:
    """Trace one bf16 32-token call of K3 (``kernel`` "K3") or K4 ("K4") at
    B lanes on a full M-slot ring."""
    case = _case(kernel, B, M)
    g = case.noise(N_TOKENS)

    def call():
        return case.run(N_TOKENS, g)

    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
    call_ms = start.elapsed_time(end)
    rows = _device_rows(prof)
    kernels = [r for r in rows if _is_kernel(r[0])]
    total = sum(r[2] for r in kernels)
    launches = sum(r[1] for r in kernels)
    busy, span = _busy_ms(prof)
    wall = kc.time_ms(call, iters=3, warmup=1)
    print(f"{kernel} bf16 B={B} M={M}, one traced {N_TOKENS}-token call: "
          f"device kernel time {total:.3f} ms, busy {busy:.3f} ms of a "
          f"{span:.3f} ms kernel span ({100 * busy / span:.1f}%) and of the "
          f"{call_ms:.3f} ms call ({100 * busy / call_ms:.1f}%), "
          f"{launches / N_TOKENS:.2f} kernel launches a token; untraced "
          f"call {wall:.3f} ms (CUDA events)")
    for key, count, ms in kernels[:top]:
        print(f"  {key[:60]:60s} launches {count:6d} {ms:9.3f} ms")
    return {"kernel": kernel, "B": B, "M": M, "device_ms": total,
            "busy_ms": busy, "span_ms": span, "traced_call_ms": call_ms,
            "busy_share": busy / span, "busy_share_call": busy / call_ms,
            "untraced_call_ms": wall, "launches_per_token": launches / N_TOKENS}


def ablate(lanes: list[int], mem: int) -> None:
    """Times K3 (each lane count, M ``mem``) and K4 (B 64, M 64) with each
    part of ``ABLATIONS`` taken out, after the unedited sources built the
    same way."""
    from . import _native
    from .profile_attention import build_variant

    root, csrc = _native.BUILD_DIR.parent / "profile_generate", _native.CSRC
    points = [("K3", B, mem) for B in lanes] + [("K4", 64, kc.GAN_MEM)]
    for part, edits in {"nothing": [], **ABLATIONS}.items():
        build_variant(edits, root / part.replace(" ", "_"), csrc)
        times = []
        for kernel, B, M in points:
            case = _case(kernel, B, M)
            g = case.noise(N_TOKENS)
            ms = kc.time_ms(lambda: case.run(N_TOKENS, g), iters=5, warmup=1)
            times.append(f"{kernel} B {B} {ms:.4f} ms")
            del case
        print(f"without {part:18s} " + "  ".join(times))
        torch.cuda.empty_cache()


def profile_attention_plain(M: int, top: int = 8) -> None:
    _, plain, args = kc.attention_case("v2", torch.bfloat16, 128, 1, M, M=M)
    plain(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        plain(*args)
        torch.cuda.synchronize()
    print(f"K1f plain version, q 128, B 1, M {M}:")
    for key, count, ms in _device_rows(prof)[:top]:
        print(f"  {key[:60]:60s} launches {count:6d} {ms:9.3f} ms")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lanes", type=int, nargs="+", default=[1, 8])
    parser.add_argument("--mem", type=int, default=kc.MEM_LEN)
    parser.add_argument("--ablate", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the card's name and power limit stand beside every number
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for B in args.lanes:
        profile_chunk("K3", B, args.mem)
    profile_chunk("K4", 64, kc.GAN_MEM)
    profile_attention_plain(args.mem)
    if args.ablate:
        ablate(args.lanes, args.mem)


if __name__ == "__main__":
    main()
