#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (run from anywhere):

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device: the card's name and power limit;
2. build: the CUDA kernels compiled from transformer_gan_torch/csrc;
3. kernels: each kernel against its plain PyTorch version at the baseline
   model's full width (L 6, H 10, d 500, DI 1000, V 310, M 4146);
4. main path: ``transformer_gan_torch.cli.generate.main`` on seeded
   full-width bf16 parameters, unconditional (8 lanes) and conditional with
   the debug incremental == batch memory check, with launch counters
   showing both kernels of the path ran; then the kernel path against the
   CPU plain path on a short full-width fp32 slice (identical ids);
5. numbers: us/token and events/s for the kernel and the plain path, and
   the attention kernels' time against their plain versions.

The line before the last is a JSON object of the path's kernels; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GEN_LENGTH = 4096


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}, default=str), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    try:
        from transformer_gan_torch import _native
        from transformer_gan_torch import kernel_check as kc
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", card=card, kind=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    _native.build(verbose=True)
    _native.lib()
    spills = [l.strip() for l in _native.BUILD_LOG["log"].splitlines()
              if "spill" in l and not l.strip().startswith("0 bytes stack")]
    phase("build", seconds=round(time.perf_counter() - t0, 2),
          library=os.path.relpath(_native.BUILD_LOG["path"], ROOT),
          spill_lines=spills)

    # 3. kernels against their plain versions, full width
    errs = {"v2": {}, "v1": {}, "gen": {}}
    for variant in ("v2", "v1"):
        for dtype in (torch.float32, torch.bfloat16):
            for q in (50, 128):
                for B in (1, 8):
                    for count in (0, 2000, kc.MEM_LEN):
                        res = kc.check_attention(variant, dtype, q, B, count)
                        if not res["ok"]:
                            fail(f"attention kernel disagrees: {res}")
                        key = res["dtype"]
                        errs[variant][key] = max(errs[variant].get(key, 0.0),
                                                 res["max_abs_err"])
    phase("kernels.attention", max_abs_err=errs["v2"],
          v1_max_abs_err=errs["v1"], cases=48,
          tol={"float32": kc.ATTN_TOL_F32,
               "bfloat16": f"{kc.ATTN_REL_TOL_BF16} * max|o|"})
    for dtype in ("float32", "bfloat16"):
        for B in (1, 8):
            for count in (0, 100, kc.MEM_LEN):
                res = kc.check_generate(dtype, B, count)
                if not res["ok"]:
                    fail(f"generate kernel disagrees: {res}")
                errs["gen"][dtype] = max(errs["gen"].get(dtype, 0.0),
                                         res["max_abs_err"])
                phase("kernels.generate", **{
                    k: res[k] for k in ("dtype", "B", "count", "ok")},
                    chunks=[{k: c[k] for k in c if k != "count"}
                            for c in res["chunks"]])
    torch.cuda.synchronize()

    # 4. main path through the CLI
    summaries = run_main_path(_native)
    slice_ref = check_slice_reference()
    phase("main_path.reference", **slice_ref)
    if not slice_ref["ok"]:
        fail("kernel path and CPU plain path disagree on the reference slice")

    # 5. numbers
    numbers = measure(kc, card)
    kernels = [
        {"name": "xl_attn_fwd_v2 (K1f)", "route": "cuda",
         "source": "transformer_gan_torch/csrc/attention.cu",
         "replaces": "transformer_gan_tpu/ops/pallas_attention_v2.py:111",
         "launches": summaries["launches"]["xl_attn_fwd_v2"],
         "max_abs_err": errs["v2"]["float32"],
         "max_abs_err_bf16": errs["v2"]["bfloat16"],
         "ms": numbers["v2"]["ms"], "plain_ms": numbers["v2"]["plain_ms"]},
        {"name": "generate_chunk (K3)", "route": "cuda",
         "source": "transformer_gan_torch/csrc/generate.cu",
         "replaces": "transformer_gan_tpu/ops/pallas_generate.py:105",
         "launches": summaries["launches"]["generate_chunk"],
         "max_abs_err": errs["gen"]["float32"],
         "max_abs_err_bf16": errs["gen"]["bfloat16"],
         "ms": numbers["gen"]["ms"], "plain_ms": numbers["gen"]["plain_ms"]},
    ]
    other = [
        {"name": "xl_attn_fwd_v1 (K2f)", "route": "cuda",
         "source": "transformer_gan_torch/csrc/attention.cu",
         "replaces": "transformer_gan_tpu/ops/pallas_attention.py:62",
         "launches": summaries["launches"]["xl_attn_fwd_v1"],
         "on_main_path": False,
         "max_abs_err": errs["v1"]["float32"],
         "max_abs_err_bf16": errs["v1"]["bfloat16"],
         "ms": numbers["v1"]["ms"], "plain_ms": numbers["v1"]["plain_ms"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "other_kernels": other}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def run_main_path(_native) -> dict:
    """Both inference configs through the CLI's main() on seeded full-width
    bf16 parameters of the baseline model."""
    from transformer_gan_torch.cli import generate as cli
    from transformer_gan_torch.config import (PACKAGED_VOCAB, inference_config,
                                              training_config)
    from transformer_gan_torch.convert import save_params
    from transformer_gan_torch.models import xl

    work = os.path.join(ROOT, "build", "chip_smoke")
    model_dir = os.path.join(work, "model")
    os.makedirs(model_dir, exist_ok=True)
    cfg = training_config("training_config/experiment_baseline.yml")
    with open(os.path.join(model_dir, "config.yml"), "w") as f:
        f.write(cfg.dump())
    xcfg = xl.XLConfig.from_cfg(cfg, 310)
    save_params(os.path.join(model_dir, "checkpoint_last.pt"),
                xl.init_xl_params(xcfg, seed=0))
    vocab, _ = cli.load_vocab(PACKAGED_VOCAB)

    def icfg(path, out, **over):
        c = inference_config(path)
        c.EVENT.vocab_file_path = PACKAGED_VOCAB
        c.MODEL.model_directory = model_dir
        c.OUTPUT.output_txt_directory = os.path.join(work, out)
        c.GENERATION.generation_length = GEN_LENGTH
        for dotted, v in over.items():
            group, key = dotted.split(".")
            setattr(getattr(c, group), key, v)
        return c

    runs = {
        "unconditional": icfg("inference_config/inference_unconditional.yml",
                              "out_uncond", **{"INPUT.num_midi_files": 8,
                                               "MODEL.debug": False}),
        "conditional_debug": icfg("inference_config/inference_conditional.yml",
                                  "out_cond", **{"INPUT.num_midi_files": 1,
                                                 "MODEL.debug": True}),
    }
    torch.cuda.synchronize()
    _native.reset_launches()
    result = {}
    for name, c in runs.items():
        gen = torch.Generator(device="cuda:0").manual_seed(1111)
        t0 = time.perf_counter()
        summary = cli.main(c, "cuda:0", gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_prefix = 50 if name == "conditional_debug" else 0
        for fp in summary["files"]:
            with open(fp) as f:
                toks = [l.strip() for l in f if l.strip()]
            if len(toks) != GEN_LENGTH + n_prefix:
                fail(f"{fp}: {len(toks)} tokens, expected "
                     f"{GEN_LENGTH + n_prefix}")
            if any(t not in vocab for t in toks):
                fail(f"{fp}: token outside the vocab")
        result[name] = {"files": len(summary["files"]),
                        "wall_s": round(wall, 3),
                        "generate_s": summary["generate_seconds"],
                        "tokens": summary["tokens"],
                        "tokens_per_s": summary["tokens"]
                        / summary["generate_seconds"]}
    launches = dict(_native.LAUNCHES)
    for k in ("xl_attn_fwd_v2", "generate_chunk"):
        if launches[k] == 0:
            fail(f"the main path never launched {k}")
    phase("main_path", launches=launches, generation_length=GEN_LENGTH,
          **result)
    return {"launches": launches}


def check_slice_reference() -> dict:
    """Prime 100 tokens and sample 64 at full width in fp32 (M 256): the
    kernel path on the card against the plain path on the CPU, same noise.
    Ids must be identical and memories agree to 1e-3."""
    from transformer_gan_torch.infer import sample as sampling
    from transformer_gan_torch.models import xl
    from transformer_gan_torch import kernel_check as kc

    cfg = kc.baseline_config("float32")
    params = xl.init_xl_params(cfg, seed=1, base_init=("normal", 0.02))
    scfg = sampling.SamplingConfig(technique="topk", topk=32, temperature=0.95)
    gen = torch.Generator().manual_seed(5)
    B, M, n_prime, length = 2, 256, 100, 64
    prime = torch.randint(2, cfg.n_token, (n_prime, B), generator=gen)
    g_all = sampling.gumbel_noise((length, B, cfg.n_token), gen)
    out = {}
    for device in ("cuda:0", "cpu"):
        p = {k: v.to(device) for k, v in params.items()}
        mems = xl.init_mems(cfg, M, B, device=device)
        _, mems = sampling.make_prime_step(cfg)(p, prime.to(device), mems)
        first = torch.full((B,), 7, dtype=torch.long, device=device)
        toks, mems = sampling.sample_scan(p, cfg, scfg, first, mems, length,
                                          g_all.to(device))
        out[device] = (toks.cpu().long(), mems.hids.cpu())
    ids_equal = bool(torch.equal(out["cuda:0"][0], out["cpu"][0]))
    mem_err = float((out["cuda:0"][1] - out["cpu"][1]).abs().max())
    return {"ids_equal": ids_equal, "mem_max_abs_err": mem_err,
            "tol": 1e-3, "ok": ids_equal and mem_err <= 1e-3}


def measure(kc, card: str) -> dict:
    """Kernel and plain times at M 4146 in bf16 (CUDA events)."""
    res = {}
    for B in (1, 8):
        case = kc.GenerateCase("bfloat16", B, kc.MEM_LEN)
        g = case.noise(32)
        ms, plain_ms = kc.time_in_turns(
            lambda: case.run(32, g), lambda: case.run(32, g, plain=True),
            iters=3)
        # a step samples one token on each of the B lanes
        line = {"B": B, "M": kc.MEM_LEN, "dtype": "bfloat16", "card": card,
                "kernel_us_per_step": ms * 1000 / 32,
                "kernel_us_per_token": ms * 1000 / (32 * B),
                "kernel_events_per_s": B * 32 / (ms / 1000),
                "plain_us_per_step": plain_ms * 1000 / 32,
                "plain_us_per_token": plain_ms * 1000 / (32 * B),
                "plain_events_per_s": B * 32 / (plain_ms / 1000)}
        phase("numbers.generate", **line)
        if B == 1:
            res["gen"] = {"ms": ms, "plain_ms": plain_ms}
        del case
    for variant in ("v2", "v1"):
        kernel, plain, args = kc.attention_case(variant, torch.bfloat16, 128,
                                                1, kc.MEM_LEN)
        ms, plain_ms = kc.time_in_turns(lambda: kernel(*args),
                                        lambda: plain(*args), iters=20)
        res[variant] = {"ms": ms, "plain_ms": plain_ms}
        phase(f"numbers.attention_{variant}", q=128, B=1, M=kc.MEM_LEN,
              dtype="bfloat16", card=card, kernel_ms=ms, plain_ms=plain_ms)
    return res


if __name__ == "__main__":
    main()
