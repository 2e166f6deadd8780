"""Device-time breakdown of the reverse straight-through chain (K6, K7) on
one CUDA card.

    python -m transformer_gan_torch.profile_chain [--ablate] [--gen-update]
        [--engine-against DIR]

One bf16 call of K6 (``chain_bwd_q_res``) and one of K7 (``chain_bwd_q``)
at the GAN op-point (n 59, B 64, M 64, count 64; the baseline model's full
width) is traced with ``torch.profiler``, as ``profile_generate`` traces
the decode chain: each CUDA kernel's launches and device milliseconds, the
busy time (the union of the kernels' intervals, which overlap under
programmatic dependent launch) over the call's own kernel span and over
its CUDA-event time inside the trace, and the kernel launches a token
(every launch of the traced call, the wrapper's few included, over its n
tokens). The untraced call's time (CUDA events) is printed beside them.

``--ablate`` rebuilds the kernel library from a copy of ``csrc/`` (under
``build/profile_chain/``; the sources are not touched) with
``kLnBwdKernels`` of ``csrc/chain_bwd_tc.cu`` flipped, so that the
LayerNorm backwards run in the other place (the consuming GEMV's prologue,
or a row kernel of their own), and times K6 and K7 in both builds (the
unedited one first, CUDA events), each held against the plain chain.

``--gen-update`` breaks one bf16 gen update (``GanPhases.gen_phase`` at B
64, the kernel path) down by part, with the device synchronized around
each: the prime, the sampler's operands, the sampling pass (K4), the
window forward, the discriminator's scoring, and in the backward the
window recompute, the chain (K6), the autograd pass over the window and the
rest of the backward (the discriminator's and the losses'); each part's
time excludes the parts inside it. ``chip_smoke.py`` runs the same
breakdown at the spanbert op-point (B 32, M 128, the BERT critic).

``--engine-against DIR`` builds the library from ``DIR``'s
``transformer_gan_torch/csrc`` (another checkout, e.g. the parent commit)
and holds this tree's bf16 K3 (B 1, M 4146), K4 and K5 (B 64, M 64) to it:
the SASS of generate.cu's and decode.cu's kernels (``cuobjdump``),
bitwise-equal outputs, and both builds' times in turns.

Each K6 / K7 trace is followed by the host's enqueue time of a call beside
the time until the card has run it (host clock, synchronized): where they
agree, the chain runs at the rate the host launches its kernels.
Weights and inputs are seeded random; their values do not change the work.
"""
from __future__ import annotations

import argparse
import difflib
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from . import _native
from . import kernel_check as kc
from .profile_attention import build_variant
from .profile_generate import _busy_ms, _device_rows, _is_kernel

B, M = 64, kc.GAN_MEM
_FLAG = "constexpr bool kLnBwdKernels = "


def profile_call(variant: str, chain, top: int = 8) -> dict:
    """Trace one call of K6 (``variant`` "res") or K7 ("recompute") on a
    ``kernel_check.ChainCase``."""

    def call():
        return chain.run(variant)

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
    kernels = [r for r in _device_rows(prof) if _is_kernel(r[0])]
    launches = sum(r[1] for r in kernels)
    busy, span = _busy_ms(prof)
    wall = kc.time_ms(call, iters=3, warmup=1)
    name = "K6" if variant == "res" else "K7"
    print(f"{name} bf16 n={chain.n} B={chain.B} M={chain.M}, one traced call: "
          f"device kernel time {sum(r[2] for r in kernels):.3f} ms, busy "
          f"{busy:.3f} ms of a {span:.3f} ms kernel span "
          f"({100 * busy / span:.1f}%) and of the {call_ms:.3f} ms call "
          f"({100 * busy / call_ms:.1f}%), {launches / chain.n:.2f} kernel "
          f"launches a token; untraced call {wall:.3f} ms (CUDA events)")
    for key, count, ms in kernels[:top]:
        print(f"  {key[:60]:60s} launches {count:6d} {ms:9.3f} ms")
    return {"kernel": name, "n": chain.n, "B": chain.B, "M": chain.M,
            "busy_ms": busy, "span_ms": span, "traced_call_ms": call_ms,
            "busy_share": busy / span, "busy_share_call": busy / call_ms,
            "untraced_call_ms": wall, "launches_per_token": launches / chain.n,
            "top": [(k[:60], c, ms) for k, c, ms in kernels[:top]]}


def enqueue_ms(variant: str, chain, iters: int = 3) -> tuple[float, float]:
    """(host ms to enqueue one call, ms until the card has run it): the
    wrapper returns once its host loop has launched every kernel, so where
    the two agree the chain runs at the host's launch rate."""
    chain.run(variant)                   # warm-up
    enq = total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain.run(variant)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq += t1 - t0
        total += time.perf_counter() - t0
    return enq / iters * 1e3, total / iters * 1e3


def _time_and_check(chain, ref) -> str:
    out = []
    for variant, name in (("res", "K6"), ("recompute", "K7")):
        ms = kc.time_ms(lambda: chain.run(variant), iters=5, warmup=1)
        err = float((chain.run(variant) - ref).abs().max())
        out.append(f"{name} {ms:.4f} ms (max |Q - plain| {err:.3g})")
    return "  ".join(out)


def ablate() -> None:
    """K6 and K7 with the LayerNorm backwards where the sources put them,
    then in the other place."""
    src = (_native.CSRC / "chain_bwd_tc.cu").read_text()
    now = src[src.index(_FLAG) + len(_FLAG):].split(";")[0]
    other = "false" if now == "true" else "true"
    where = {"false": "in the GEMV prologues", "true": "in row kernels"}
    root, csrc = _native.BUILD_DIR.parent / "profile_chain", _native.CSRC
    chain = kc.ChainCase("bfloat16", B, M)
    ref = chain.run("plain")
    print(f"plain chain: max |Q| {float(ref.abs().max()):.4g}, limit "
          f"{kc.CHAIN_REL_TOL_BF16 * float(ref.abs().max()):.4g}")
    for flag in (now, other):
        edits = [] if flag == now else [("chain_bwd_tc.cu", _FLAG + now,
                                         _FLAG + flag)]
        build_variant(edits, root / f"ln_kernels_{flag}", csrc)
        print(f"LayerNorm backwards {where[flag]:22s} {_time_and_check(chain, ref)}",
              flush=True)
    torch.cuda.empty_cache()


def _sass(lib: Path) -> dict[str, str]:
    """Each kernel's SASS in ``lib`` (``cuobjdump -sass``), addresses and
    encodings stripped: mangled name -> instruction text."""
    out = subprocess.run([str(Path(_native._nvcc()).parent / "cuobjdump"),
                          "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            funcs[name] = []
        elif name is not None and line.startswith("/*") and "*/" in line:
            text = line.split("*/", 1)[1].split("/*")[0].strip()
            if text:
                funcs[name].append(text)
    return {k: "\n".join(v) for k, v in funcs.items()}


def _closest_diff(name: str, text: str, candidates: dict) -> None:
    """Print how a kernel's SASS differs from the most similar one of
    ``candidates`` of the same source file: instruction counts and the
    differing lines."""
    unit = "generate_cu" if "generate_cu" in name else "decode_cu"
    a = text.splitlines()
    best = max((v.splitlines() for k, v in candidates.items() if unit in k),
               key=lambda b: difflib.SequenceMatcher(None, a, b).ratio())
    diff = [d for d in difflib.unified_diff(a, best, lineterm="", n=0)
            if d[:1] in "+-" and d[:3] not in ("---", "+++")]
    print(f"  {name[:90]}: {len(a)} / {len(best)} instructions, "
          f"{len(diff)} lines differ: {diff[:8]}")


def engine_against(other: Path) -> None:
    """This tree's bf16 K3 / K4 / K5 against the library built from
    ``other``'s sources: the SASS of the forward chain's kernels, bitwise
    outputs, times in turns (ABBA twice)."""
    cases = {"K3 B 1, M 4146": kc.GenerateCase("bfloat16", 1, kc.MEM_LEN),
             "K4 B 64, M 64": kc.DecodeCase("bfloat16", B, M),
             "K5 step 5, B 64, M 64": kc.DecodeCase("bfloat16", B, M)}
    noise = {k: c.noise(32) for k, c in cases.items()}

    def run(key):
        c, g = cases[key], noise[key]
        if key.startswith("K5"):
            L, _, H, Bn, _, dh = c.kv.shape
            ring = torch.zeros((L, 2, H, Bn, 32, dh), dtype=c.kv.dtype,
                               device=c.kv.device)
            return c.ops.fused_decode_step(c.stacked, c.cfg, c.kv, c.R, ring,
                                           c.ids, g[5], 5, c.count)
        return c.run(32, g)

    root = _native.BUILD_DIR.parent / "profile_chain"
    handles, sass = {}, {}
    for turn, src in (("this", _native.CSRC),
                      ("other", other / "transformer_gan_torch" / "csrc")):
        build_variant([], root / turn, src)
        handles[turn] = _native._lib
        sass[turn] = _sass(_native.library_path())
    # every kernel of the other build's generate.cu and decode.cu (K3, K4,
    # K5) against a kernel of this build with the same instructions (the
    # names differ: the GEMV gained its policy argument)
    theirs = {k: v for k, v in sass["other"].items()
              if "generate_cu" in k or "decode_cu" in k}
    ours = set(sass["this"].values())
    same = sum(v in ours for v in theirs.values())
    print(f"K3 / K4 / K5 kernels (generate.cu, decode.cu) of {other}'s build "
          f"with an instruction-identical kernel in this tree's: {same} of "
          f"{len(theirs)}")
    for name, text in theirs.items():
        if text not in ours:
            _closest_diff(name, text, sass["this"])
    outs, times = {}, {k: {} for k in cases}
    for turn in ("this", "other", "other", "this") * 2:
        _native._lib = handles[turn]
        for key in cases:
            out = tuple(t.clone() for t in run(key))
            torch.cuda.synchronize()
            outs.setdefault(turn, {}).setdefault(key, out)
            # K5 (one token) is host-bound: more calls a turn
            iters = 20 if key.startswith("K5") else 5
            times[key].setdefault(turn, []).append(
                kc.time_ms(lambda: run(key), iters=iters, warmup=1))
    for key in cases:
        same = all(torch.equal(a, b) for a, b in zip(outs["this"][key],
                                                     outs["other"][key]))
        t = {k: sum(v) / len(v) for k, v in times[key].items()}
        print(f"{key:24s} outputs bitwise equal: {same}; this tree "
              f"{t['this']:.4f} ms, {other} {t['other']:.4f} ms")


class _Parts:
    """Synchronized host timers around wrapped functions; a part's time
    excludes the wrapped calls inside it."""

    def __init__(self):
        self.stack, self.ms = [], {}

    def wrap(self, owner, attr, label):
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            name = label(self.stack) if callable(label) else label
            torch.cuda.synchronize()
            self.stack.append([name, 0.0])
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                _, inner = self.stack.pop()
                self.ms[name] = self.ms.get(name, 0.0) + ms - inner
                if self.stack:
                    self.stack[-1][1] += ms
        setattr(owner, attr, timed)
        return fn


def gen_update(case=None) -> dict:
    """One bf16 gen update broken down by part (``case``: a
    ``kernel_check.GanCase``; by default the cnn config at B 64). Prints the
    parts and returns {untimed_ms, total_ms, parts: {name: ms}}."""
    from .models import gan, xl
    from .ops import chain_bwd as chain_ops
    case = case or kc.GanCase("bfloat16", B, "cuda", route="kernel",
                              host_draws=False)
    ph = case.phases
    ph.gen_phase(1)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ph.gen_phase(1)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    parts = _Parts()
    saved = [(gan, "prime_context", "prime"),
             (gan, "_sampler_operands", "sampler operands"),
             (gan, "_sample_fake_chunks_fused", "sampling pass (K4)"),
             (gan, "_window_st", "window forward"),
             (gan, "score_chunk", "discriminator scoring (forward)"),
             (xl, "decode_recompute_window",
              lambda s: s[-1][0] if s and s[-1][0] == "window forward"
              else "window recompute (backward)"),
             (chain_ops, "chain_bwd_q_res", "chain (K6)"),
             (torch.autograd, "grad",
              lambda s: "autograd pass over the window" if s
              else "backward: discriminator, losses")]
    originals = [(o, a, parts.wrap(o, a, lab)) for o, a, lab in saved]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ph.gen_phase(1)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)
    print(f"gen update bf16 B {case.B}: {plain_ms:.3f} ms untimed, "
          f"{total:.3f} ms with a synchronize around each part")
    for name, ms in sorted(parts.ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name:34s} {ms:9.3f} ms ({100 * ms / total:.1f}%)")
    rest = total - sum(parts.ms.values())
    print(f"  {'the rest (optimizer, loss, host)':34s} {rest:9.3f} ms "
          f"({100 * rest / total:.1f}%)")
    return {"untimed_ms": plain_ms, "total_ms": total,
            "parts": dict(parts.ms, **{"the rest (optimizer, loss, host)":
                                       rest})}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ablate", action="store_true")
    parser.add_argument("--gen-update", action="store_true")
    parser.add_argument("--engine-against", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the card's name and power limit stand beside every number
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    chain = kc.ChainCase("bfloat16", B, M)
    for variant in ("res", "recompute"):
        profile_call(variant, chain)
        enq, total = enqueue_ms(variant, chain)
        print(f"  host enqueue {enq:.3f} ms of {total:.3f} ms to the end of "
              "the call (host clock)")
    del chain
    if args.gen_update:
        gen_update()
    if args.ablate:
        ablate()
    if args.engine_against is not None:
        engine_against(args.engine_against)


if __name__ == "__main__":
    main()
