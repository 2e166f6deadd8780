"""Device-time breakdown of one MLE training step on one CUDA card.

    python -m transformer_gan_torch.profile_train [--batch 128] [--mem 1024]
        [--bert]

At the baseline model's full width in bf16 with dropout 0.1 and a full
memory ring (the training op-point by default), one step of the kernel path
and one of the plain path (attention routed to ``rel_attention_kv``) are
traced with ``torch.profiler``; for each the script prints the CUDA kernels'
launches and device milliseconds, their total, the step's wall time and the
device's busy share. Weights and batch are seeded random; their values do
not change the work done.

``--bert`` traces the BERT stack's two calls the same way instead: one MLM
step at the pretrainer's defaults (16 rows of 512 tokens, 5 layers of 768,
bf16, on a seeded random corpus under ``build/profile_train/``) and one dis
phase at the spanbert op-point (``experiment_spanbert.yml``, batch 128 in 4
micro-batches of 32; a randomly initialised critic, frozen as configured).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import kernel_check as kc
from .utils import spans


def profile_call(name: str, fn, wall_ms, top: int = 14,
                 width: int = 64) -> dict:
    """Trace one call of ``fn`` (after a warm-up call) and print its CUDA
    kernels' launches and device ms (names cut to ``width``) beside
    ``wall_ms()``, the untraced call's wall time."""
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    # device-side events only (kernels, copies, memsets): the host ops and
    # autograd nodes above them, and the device copies of the spans' ranges,
    # report their children's device time again
    kernels = sorted(((e.key, e.count, e.device_time_total / 1000.0)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.count > 0
                      and e.key not in spans.NAMES),
                     key=lambda r: -r[2])
    total = sum(r[2] for r in kernels)
    wall = wall_ms()
    print(f"{name}: device kernel time {total:.3f} ms per call, wall "
          f"{wall:.3f} ms, device busy {100 * total / wall:.1f}%, "
          f"{sum(r[1] for r in kernels)} device launches")
    for key, count, ms in kernels[:top]:
        print(f"  {key[:width]:{width}s} launches {count:5d} {ms:9.3f} ms "
              f"{100 * ms / total:5.1f}%")
    return {"device_ms": total, "wall_ms": wall}


def profile_step(case: kc.TrainCase, plain: bool, top: int = 14) -> dict:
    return profile_call("plain path" if plain else "kernel path",
                        lambda: case.steps(1, plain=plain),
                        lambda: 1000 * case.steps(2, plain=plain), top)


def _wall_ms(fn, n: int = 2) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def profile_bert(top: int = 14) -> None:
    """One bf16 MLM step and one spanbert dis phase, traced."""
    from .bert.mlm import MlmTrainer
    from .config import PACKAGED_VOCAB
    work = Path(__file__).resolve().parent.parent / "build" / "profile_train"
    rng = np.random.RandomState(0)
    os.makedirs(work / "train", exist_ok=True)
    for k in range(8):
        np.save(work / "train" / f"{k:05d}.npy",
                rng.randint(2, 310, 2048).astype(np.int32))
    tr = MlmTrainer(str(work), str(work / "out"), PACKAGED_VOCAB,
                    compute_dtype="bfloat16", device="cuda")
    batch = torch.from_numpy(tr.train_blocks[:tr.batch_size]).cuda()

    def step():
        tr.train_step(batch)

    profile_call("MLM step (16 x 512, bf16)", step,
                 lambda: _wall_ms(step, 5), top, width=120)
    del tr
    case = kc.GanCase("bfloat16", 128, "cuda", host_draws=False,
                      config="experiment_spanbert.yml")

    def dis():
        case.phases.dis_phase(1)

    profile_call("spanbert dis phase (B 128: 4 x 32 lanes, bf16)", dis,
                 lambda: _wall_ms(dis), top, width=120)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--tgt", type=int, default=128)
    parser.add_argument("--mem", type=int, default=1024)
    parser.add_argument("--bert", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    # the card's name and power limit stand beside every number
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.bert:
        profile_bert()
        return
    case = kc.TrainCase(B=args.batch, tgt=args.tgt, M=args.mem)
    case.steps(-(-args.mem // args.tgt))  # fill the memory ring
    for plain in (False, True):
        profile_step(case, plain)


if __name__ == "__main__":
    main()
