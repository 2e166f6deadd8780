"""Device-time breakdown of one MLE training step on one CUDA card.

    python -m transformer_gan_torch.profile_train [--batch 128] [--mem 1024]

At the baseline model's full width in bf16 with dropout 0.1 and a full
memory ring (the training op-point by default), one step of the kernel path
and one of the plain path (attention routed to ``rel_attention_kv``) are
traced with ``torch.profiler``; for each the script prints the CUDA kernels'
launches and device milliseconds, their total, the step's wall time and the
device's busy share. Weights and batch are seeded random; their values do
not change the work done.
"""
from __future__ import annotations

import argparse
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import kernel_check as kc


def profile_step(case: kc.TrainCase, plain: bool, top: int = 14) -> dict:
    case.steps(1, plain=plain)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        case.steps(1, plain=plain)
    # device-side events only (kernels, copies, memsets): the host ops and
    # autograd nodes above them report their children's device time again
    kernels = sorted(((e.key, e.count, e.device_time_total / 1000.0)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.count > 0),
                     key=lambda r: -r[2])
    total = sum(r[2] for r in kernels)
    wall = 1000 * case.steps(2, plain=plain)
    name = "plain" if plain else "kernel"
    print(f"{name} path: device kernel time {total:.3f} ms per step, wall "
          f"{wall:.3f} ms, device busy {100 * total / wall:.1f}%")
    for key, count, ms in kernels[:top]:
        print(f"  {key[:64]:64s} launches {count:5d} {ms:9.3f} ms "
              f"{100 * ms / total:5.1f}%")
    return {"device_ms": total, "wall_ms": wall}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--tgt", type=int, default=128)
    parser.add_argument("--mem", type=int, default=1024)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    # the card's name and power limit stand beside every number
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    case = kc.TrainCase(B=args.batch, tgt=args.tgt, M=args.mem)
    case.steps(-(-args.mem // args.tgt))  # fill the memory ring
    for plain in (False, True):
        profile_step(case, plain)


if __name__ == "__main__":
    main()
