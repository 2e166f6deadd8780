"""Device-time breakdown of the bf16 attention kernels on one CUDA card.

    python -m transformer_gan_torch.profile_attention [--ablate]

At the baseline model's width (H 10, d_head 50) in bf16, traces with
``torch.profiler`` K1f at generation's prime shape (q 128, B 1, M 4146,
same_length: split keys and the combine kernel) and at the MLE step's shape
(q 128, B 128, M 1024, dropatt 0.1), K1b at the latter (K1b runs in training
only), K2f at the prime shape and at the MLE step's mem 0 shape (q 128,
B 128, M 0), and K2b at the latter with dropatt 0.1; prints each CUDA
kernel's launches and mean device microseconds. Then times K2f and K1f at
the prime shape for several key-split counts (device time of their kernels).

``--ablate`` rebuilds the kernel library from edited copies of ``csrc/``
(under ``build/profile_attention/``; the sources are not touched), each
with one part of the tensor-core kernels taken out, and times K2f and K2b
at q 128, B 512, M 0 and K1f and K1b at the MLE shape (CUDA events): the
results are wrong, only the times mean something. What a part's removal
saves is an upper bound on what it costs.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import _native
from . import kernel_check as kc
from .ops import attention as attn_ops
from .utils import spans

TRAIN_MEM = 1024  # the MLE step's memory (experiment_baseline.yml)

# part taken out -> (file, text, replacement) edits of the sources
ABLATIONS = {
    "mma": [("attention_tc.cuh", '  asm volatile(\n      "mma.sync',
             "  d[0] += __int_as_float((a[0] ^ a[1] ^ b0 ^ b1) & 0x7fffff);\n"
             '  if (0) asm volatile(\n      "mma.sync')],
    "loads": [("attention_tc.cuh",
               "cp_async4(tile + r * kStride + c, ok ? src + c : any, ok);",
               "(void)ok;")],
    "next-tile prefetch": [
        ("attention_v1_tc.cu", "if (tt + 1 < t_hi) load_kv(tt + 1, buf ^ 1);",
         ""),
        ("attention_v1_tc_bwd.cu",
         "if (qt + 1 < nq) load_rows(qt + 1, buf ^ 1);", ""),
        ("attention_v2_tc.cu", "if (u + 1 < nt) load_kv(tt + 1, buf ^ 1);",
         ""),
        ("attention_v2_tc_bwd.cu", "      load_kv(u + 1, buf ^ 1);\n", "")],
    "per-score mask": [
        ("attention_v1_tc.cu", "    if (!uniform && iw0 + 15 < q",
         "    if (true || !uniform && iw0 + 15 < q"),
        ("attention_v1_tc_bwd.cu", "    if (!uniform && i0 + kT - 1 < q",
         "    if (true || !uniform && i0 + kT - 1 < q"),
        ("attention_v2_tc.cu", "    if (!uniform && iw0 + 15 < q",
         "    if (true || !uniform && iw0 + 15 < q"),
        ("attention_v2_tc_bwd.cu", "    if (!uniform && iw0 + 15 < q",
         "    if (true || !uniform && iw0 + 15 < q")],
    "exp": [("attention_v1_tc.cu", "__expf(sv_ - m_run[r])", "(sv_ - m_run[r])"),
            ("attention_v1_tc_bwd.cu", "__expf(s - sm[il])", "(s - sm[il])"),
            ("attention_v2_tc.cu", "__expf(sv_ - m_run[r])", "(sv_ - m_run[r])"),
            ("attention_v2_tc_bwd.cu", "__expf(s - m) * inv_l", "(s - m) * inv_l")],
    "dropout hash": [
        ("common.cuh",
         "return tg_mix(row_key ^ (static_cast<unsigned int>(j) + 0xbb67ae85u)) >= thr;",
         "return (row_key ^ static_cast<unsigned int>(j)) >= thr;")],
    "skew stores (K1)": [
        ("attention_tc.cuh",
         "if (x >= 0 && x < kTile) scr[row * kScrStride + x] = w[n][2 * rr + c];",
         "(void)x;")],
}


def kernel_rows(fn, n: int = 20) -> list:
    """(kernel name, launches per call, mean device us) of ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # the spans' ranges show on the device too, covering their kernels
    return [(e.key, e.count / n, e.device_time_total / e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count > 0
            and e.key not in spans.NAMES]


def cases(B: int = 128) -> dict:
    """name -> callable: K1f at the prime and MLE shapes, K1b at the MLE
    shape, K2f at the prime shape and at M 0, K2b at M 0 (``B`` the batch
    of the M 0 cases)."""
    out = {}
    for variant, name in (("v2", "K1f"), ("v1", "K2f")):
        k, _, prime = kc.attention_case(variant, torch.bfloat16, 128, 1,
                                        kc.MEM_LEN)
        out[f"{name} q 128, B 1, M {kc.MEM_LEN}"] = (
            lambda k=k, a=prime: k(*a))
    for variant, name, M, b in (("v2", "K1", TRAIN_MEM, 128), ("v1", "K2", 0, B)):
        fwd, _, bwd, _, fa, ba, kw = kc.attention_bwd_case(
            variant, torch.bfloat16, 128, b, M, M, rate=0.1)
        bwd_args = ba(*fwd(*fa, **kw))
        shape = f"q 128, B {b}, M {M}, dropatt 0.1"
        out[f"{name}f {shape}"] = lambda f=fwd, a=fa, kw=kw: f(*a, **kw)
        out[f"{name}b {shape}"] = lambda f=bwd, a=bwd_args, kw=kw: f(*a, **kw)
    return out


def device_us(fn, n: int = 20) -> float:
    """Device microseconds of all kernels of one call of ``fn``."""
    return sum(per_call * us for _, per_call, us in kernel_rows(fn, n))


def build_variant(edits, root: Path, csrc: Path) -> None:
    """Point ``_native`` at an edited copy of ``csrc`` and load it."""
    shutil.rmtree(root, ignore_errors=True)
    src = root / "csrc"
    shutil.copytree(csrc, src)
    for name, old, new in edits:
        path = src / name
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"ablation edit not found in {name}: {old!r}")
        path.write_text(text.replace(old, new))
    _native.CSRC, _native.BUILD_DIR, _native._lib = src, root / "lib", None
    _native.lib()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ablate", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for name, fn in cases().items():
        print(name)
        for key, per_call, us in kernel_rows(fn):
            print(f"  {key[:72]:72s} x{per_call:g} {us:9.2f} us")
    chosen = attn_ops.v1_key_splits
    for variant in ("v1", "v2"):
        k, _, prime = kc.attention_case(variant, torch.bfloat16, 128, 1,
                                        kc.MEM_LEN)
        for splits in (1, 4, 8, 14, 20, 28):
            attn_ops.v1_key_splits = lambda *a, s=splits: s
            print(f"{'K2f' if variant == 'v1' else 'K1f'} prime shape, "
                  f"{splits:2d} key splits: "
                  f"{device_us(lambda: k(*prime)):.2f} us on the device")
        attn_ops.v1_key_splits = chosen
    if not args.ablate:
        return
    root, csrc = _native.BUILD_DIR.parent / "profile_attention", _native.CSRC
    for part, edits in {"nothing": [], **ABLATIONS}.items():
        build_variant(edits, root / part.replace(" ", "_"), csrc)
        fns = cases(B=512)
        # CUDA events: a call takes far longer than its launch here, and the
        # profiler drops kernel records after a few traces in one process
        times = {n: kc.time_ms(fn, 20, 3) for n, fn in fns.items()
                 if "dropatt" in n}
        print(f"without {part:18s} " + "  ".join(
            f"{n.split(' ')[0]} {ms:.4f} ms" for n, ms in times.items()))
        del fns
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
