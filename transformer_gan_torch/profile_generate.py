"""Device-time breakdown of the generation kernels on one CUDA card.

    python -m transformer_gan_torch.profile_generate [--lanes 1 8] [--mem 4146]

For each lane count, one 32-token chunk of the fused sampling kernel chain
(K3) at the baseline model's full width in bf16 on a full ring is traced
with ``torch.profiler``; the script prints each CUDA kernel's launches and
device milliseconds, their total, the chunk's wall time from CUDA events and
the device's busy share. Then the plain version of the XL attention forward
(K1f) at q 128, B 1 is broken down the same way. Weights and cache are
seeded random; their values do not change the work done.
"""
from __future__ import annotations

import argparse
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from . import kernel_check as kc

# host-side ops and copies that the trace also lists with a device time
_NOT_KERNELS = ("aten::", "Activity Buffer", "Memcpy", "Memset")


def _device_rows(prof) -> list:
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", 0)
        if dt > 0 and e.count > 0:
            rows.append((e.key, e.count, dt / 1000.0))
    return sorted(rows, key=lambda r: -r[2])


def profile_chunk(B: int, M: int, top: int = 12) -> dict:
    case = kc.GenerateCase("bfloat16", B, M, M=M)
    g = case.noise(32)
    case.run(32, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        case.run(32, g)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    kernels = [r for r in rows if not any(k in r[0] for k in _NOT_KERNELS)]
    total = sum(r[2] for r in kernels)
    wall = kc.time_ms(lambda: case.run(32, g), iters=3, warmup=1)
    print(f"K3 B={B} M={M}: device kernel time {total:.3f} ms per 32-token "
          f"chunk, wall {wall:.3f} ms (CUDA events), device busy "
          f"{100 * total / wall:.1f}%")
    for key, count, ms in kernels[:top]:
        print(f"  {key[:60]:60s} launches {count:6d} {ms:9.3f} ms")
    return {"B": B, "M": M, "device_ms": total, "wall_ms": wall}


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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the card's name and power limit stand beside every number
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for B in args.lanes:
        profile_chunk(B, args.mem)
    profile_attention_plain(args.mem)


if __name__ == "__main__":
    main()
