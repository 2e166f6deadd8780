#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (run from anywhere):

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device: the card's name and power limit;
2. build: the CUDA kernels compiled from transformer_gan_torch/csrc;
3. kernels: each kernel against its plain PyTorch version at the baseline
   model's full width (L 6, H 10, d 500, DI 1000, V 310): the attention
   forwards at M 4146, the attention backwards (K1b, K2b) and the forwards
   with dropout at q 128, M 0 and 1024, B 1, 8 and the training batch 128,
   K1f / K1b at the GAN config's MLE shape (q 512, M 128, B 64), the
   same_length window without memory, bf16 K1 and K2 (tensor cores) at
   ragged q 77 / 50 and, with the keys split across blocks, at M 4146 (B 1,
   3, 8) against the plain combine of as many key ranges (the phase prints
   the design and the splits), the fused sampler (K3), the GAN's
   gumbel sampler (K4, K5) and its reverse chain (K6, K7) at M 64;
4. main path, generation: ``transformer_gan_torch.cli.generate.main`` on
   seeded full-width bf16 parameters, unconditional (8 lanes) and
   conditional with the debug incremental == batch memory check, with
   launch counters showing the kernels of the path ran (K1f on the tensor
   cores, K3); then the kernel
   path against the CPU plain path on a short full-width fp32 slice;
5. main path, training: ``transformer_gan_torch.cli.train`` on
   experiment_baseline.yml (batch 128) over a seeded random corpus for 8
   steps with an eval and checkpoints (K1f, K1b, bf16 on the tensor
   cores), a 2-step run at TRAIN.mem_length 0 with random_crop (K2f, K2b),
   the generation CLI on
   the trained run directory, and two fp32 full-width training steps of the
   kernel path against the CPU plain path;
6. main path, GAN: ``transformer_gan_torch.cli.train`` on
   experiment_cnn.yml (batch 64, warm start from the training run) with a
   dis and a gen phase at steps 1 and 2 and a restart (K4, K6), a second run
   on the per-token sampler and the recomputing chain (K5, K7), and one
   fp32 dis and gen update of the kernel path on the card against the plain
   path on the CPU;
7. numbers: us/token and events/s for generation, training tokens/s, the
   GAN phases' ms and sampled tokens/s, and every kernel's time against its
   plain version, its least time on the card (bound) and, where one
   PyTorch call computes the same function, that call's time (K2f at
   M 4146, B 1 and at the training shape q 128, B 128, M 0 against SDPA's
   forward; K2b against SDPA's backward alone); K1f and K1b at the MLE
   step's shape (q 128, B 128, M 1024, dropatt 0.1) beside the v1 route on
   the same inputs (BD by torch.matmul and a gather, then K2f / K2b), a
   yardstick the port never calls. The plain versions of K1f / K1b at that
   shape take 5 timed calls (their kernels 5 too), and the fp32 CUDA-core
   K1f / K1b, the on-card references, are timed against their fp32 plain
   versions.

The line before the last is a JSON object of the paths' kernels; the last
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
        from transformer_gan_torch.ops import attention as attn_ops
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
    splits, split_err, cases = {}, 0.0, 0
    reset3 = torch.tensor([0, 1, 0], device="cuda", dtype=torch.int32)
    grid = [(q, B, count, None) for q in (50, 128) for B in (1, 8)
            for count in (0, 2000, kc.MEM_LEN)]
    for variant in ("v2", "v1"):
        for dtype in (torch.float32, torch.bfloat16):
            # K2f splits the keys at B 1, 3 and 8: the last case with reset rows
            for q, B, count, reset in grid + [(128, 3, kc.MEM_LEN, reset3)]:
                res = kc.check_attention(variant, dtype, q, B, count,
                                         reset=reset)
                cases += 1
                if not res["ok"]:
                    fail(f"attention kernel disagrees: {res}")
                key = res["dtype"]
                errs[variant][key] = max(errs[variant].get(key, 0.0),
                                         res["max_abs_err"])
                if "splits" in res:
                    splits[f"{variant} q {q}, B {B}"] = res["splits"]
                    split_err = max(split_err,
                                    res.get("split_max_abs_err", 0.0))
    phase("kernels.attention", max_abs_err=errs["v2"],
          v1_max_abs_err=errs["v1"], cases=cases,
          design={str(d).split(".")[-1]: attn_ops.attention_design(d)
                  for d in (torch.float32, torch.bfloat16)},
          bf16_key_splits=splits,
          split_vs_plain_combine_max_abs_err=split_err,
          tol={"float32": kc.ATTN_TOL_F32,
               "bfloat16": f"{kc.ATTN_REL_TOL_BF16} * max|o|"})
    bwd_errs = check_attention_bwd(kc)
    gan_attn = check_gan_attention(kc)
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
    dec_errs = check_decode(kc)
    chain_errs = check_chain(kc)
    torch.cuda.synchronize()

    # 4. main path, generation, through the CLI
    summaries = run_main_path(_native)
    slice_ref = check_slice_reference()
    phase("main_path.reference", **slice_ref)
    if not slice_ref["ok"]:
        fail("kernel path and CPU plain path disagree on the reference slice")

    # 5. main path, training, through the CLI
    train_launches, mle_run = run_train_path(_native)
    train_ref = check_train_reference()
    phase("main_path.train_reference", **train_ref)
    if not train_ref["ok"]:
        fail("kernel path and CPU plain path disagree on the training step")

    # 6. main path, GAN, through the CLI
    gan_launches = run_gan_path(_native, mle_run)
    gan_ref = kc.check_gan_reference()
    phase("main_path.gan_reference", **gan_ref)
    if not gan_ref["ok"]:
        fail("kernel path and CPU plain path disagree on the GAN updates")

    # 7. numbers
    numbers = measure(kc, card)
    numbers.update(measure_train(kc, card))
    numbers.update(measure_gan(kc, card))
    paths = {"generate": summaries["launches"], "train": train_launches,
             "gan": gan_launches}
    launches = {k: sum(p[k] for p in paths.values()) for k in _native.LAUNCHES}
    by_path = {k: {n: p[k] for n, p in paths.items()} for k in _native.LAUNCHES}

    def entry(name, source, replaces, key, f32, bf16, num):
        e = {"name": name, "route": "cuda",
             "source": f"transformer_gan_torch/csrc/{source}",
             "replaces": replaces, "launches": launches[key],
             "launches_by_path": by_path[key], "max_abs_err": f32,
             "max_abs_err_bf16": bf16, "ms": num["ms"],
             "plain_ms": num["plain_ms"], "bound_ms": num["bound_ms"],
             "bound_by": num["bound_by"],
             "library_ms": num.get("library_ms"),
             "library_call": num.get("library_call"),
             "shape": num.get("shape")}
        if key + "_tc" in launches:   # bf16 K1 / K2 run on the tensor cores
            e["launches_tensor_core"] = launches[key + "_tc"]
            e["source_fp32"] = "transformer_gan_torch/csrc/" + (
                "attention.cu" if "fwd" in key else "attention_bwd.cu")
        for k, v in num.items():
            if k not in e and k not in ("ms", "plain_ms", "bound_ms",
                                        "bound_by"):
                e[k] = v
        return e

    v2f = [errs["v2"], bwd_errs["fwd_v2"], gan_attn["fwd_v2"]]
    v1f = [errs["v1"], bwd_errs["fwd_v1"], gan_attn["fwd_v1"]]
    # K1f / K1b: every call enters tg_xl_attn_fwd / tg_xl_attn_bwd of
    # attention.cu / attention_bwd.cu, which run fp32 on the CUDA cores and
    # send bf16 to the tensor-core kernels (their own entries, timed at the
    # MLE step's shape); the two entries of attention.cu / attention_bwd.cu
    # time the bf16 calls at generation's prime shape and at the cnn
    # config's MLE shape, and carry the fp32 CUDA-core kernels' times.
    kernels = [
        entry("xl_attn_fwd_v2 (K1f)", "attention.cu",
              "transformer_gan_tpu/ops/pallas_attention_v2.py:111",
              "xl_attn_fwd_v2", *worst(v2f), numbers["v2"]),
        entry("xl_attn_bwd_v2 (K1b)", "attention_bwd.cu",
              "transformer_gan_tpu/ops/pallas_attention_v2.py:166",
              "xl_attn_bwd_v2", *worst([bwd_errs["v2"], gan_attn["v2"]]),
              numbers["bwd_v2"]),
        entry("xl_attn_fwd_v1 (K2f)", "attention_v1_tc.cu",
              "transformer_gan_tpu/ops/pallas_attention.py:62",
              "xl_attn_fwd_v1", *worst(v1f), numbers["v1"]),
        entry("xl_attn_bwd_v1 (K2b)", "attention_v1_tc_bwd.cu",
              "transformer_gan_tpu/ops/pallas_attention.py:98",
              "xl_attn_bwd_v1", *worst([bwd_errs["v1"], gan_attn["v1"]]),
              numbers["bwd_v1"]),
        entry("generate_chunk (K3)", "generate.cu",
              "transformer_gan_tpu/ops/pallas_generate.py:105",
              "generate_chunk", errs["gen"]["float32"],
              errs["gen"]["bfloat16"], numbers["gen"]),
        entry("decode_chunk (K4)", "decode.cu",
              "transformer_gan_tpu/ops/pallas_decode.py:359",
              "decode_chunk", *worst([dec_errs["K4"]]), numbers["K4"]),
        entry("decode_step (K5)", "decode.cu",
              "transformer_gan_tpu/ops/pallas_decode.py:82",
              "decode_step", *worst([dec_errs["K5"]]), numbers["K5"]),
        entry("chain_bwd_res (K6)", "chain_bwd.cu",
              "transformer_gan_tpu/ops/pallas_chain_bwd.py:301",
              "chain_bwd_res", *worst([chain_errs["K6"]]), numbers["K6"]),
        entry("chain_bwd_recompute (K7)", "chain_bwd.cu",
              "transformer_gan_tpu/ops/pallas_chain_bwd.py:103",
              "chain_bwd_recompute", *worst([chain_errs["K7"]]),
              numbers["K7"]),
        entry("xl_attn_fwd_v2_tc (K1f, bf16 on the tensor cores)",
              "attention_v2_tc.cu",
              "transformer_gan_tpu/ops/pallas_attention_v2.py:111",
              "xl_attn_fwd_v2_tc", *(worst(v2f)[1],) * 2, numbers["v2_tc"]),
        entry("xl_attn_bwd_v2_tc (K1b, bf16 on the tensor cores)",
              "attention_v2_tc_bwd.cu",
              "transformer_gan_tpu/ops/pallas_attention_v2.py:166",
              "xl_attn_bwd_v2_tc",
              *(worst([bwd_errs["v2"], gan_attn["v2"]])[1],) * 2,
              numbers["bwd_v2_tc"]),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def worst(dicts) -> tuple:
    """(fp32, bf16) max abs errors over several checks' {dtype: err}."""
    return tuple(max(d.get(k, 0.0) for d in dicts)
                 for k in ("float32", "bfloat16"))


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
    for k in ("xl_attn_fwd_v2", "xl_attn_fwd_v2_tc", "generate_chunk"):
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
            bound, by = kc.bound_ms(*kc.sampler_work(32, 1, kc.MEM_LEN,
                                                     kc.MEM_LEN))
            res["gen"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                          "bound_by": by, "library_ms": None,
                          "library_call": "none computes top-k sampling "
                          "through the decoder",
                          "shape": f"32 tokens, B 1, M {kc.MEM_LEN}, bf16"}
        del case
    for variant in ("v2", "v1"):
        kernel, plain, args = kc.attention_case(variant, torch.bfloat16, 128,
                                                1, kc.MEM_LEN)
        ms, plain_ms = kc.time_in_turns(lambda: kernel(*args),
                                        lambda: plain(*args), iters=20)
        bound, by = kc.bound_ms(*kc.attention_work(
            variant, 128, 1, kc.MEM_LEN, kc.MEM_LEN, True))
        res[variant] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by,
                        "shape": f"q 128, B 1, M {kc.MEM_LEN}, bf16"}
        if variant == "v2":
            # the fp32 CUDA-core kernel, the on-card reference
            kernel, plain, args = kc.attention_case(variant, torch.float32,
                                                    128, 1, kc.MEM_LEN)
            f32 = kc.time_in_turns(lambda: kernel(*args),
                                   lambda: plain(*args), iters=10)
            res[variant]["fp32_ms"], res[variant]["fp32_plain_ms"] = f32
            res[variant]["fp32_bound_ms"] = kc.bound_ms(*kc.attention_work(
                variant, 128, 1, kc.MEM_LEN, kc.MEM_LEN, True, es=4),
                "float32")[0]
            res["v2_tc"] = dict(measure_k1f_train_shape(kc, card),
                                other_shapes=[{k: v for k, v in res[variant].items()
                                               if not k.startswith("fp32")}])
        if variant == "v1":
            fwd, _, _ = kc.sdpa_case(128, 1, kc.MEM_LEN, kc.MEM_LEN, True)
            res[variant]["library_ms"] = kc.time_ms(fwd, 20)
            res[variant]["library_call"] = (
                "scaled_dot_product_attention(q + r_w_bias, k, v, attn_mask="
                "BD * scale + mask), forward")
            res[variant]["other_shapes"] = [measure_k2f_train_shape(kc, card)]
        else:
            for r in (res["v2"], res["v2_tc"]):
                r["library_ms"] = None
                r["library_call"] = ("none: the position term comes from rk "
                                     "inside the kernel")
        phase(f"numbers.attention_{variant}", q=128, B=1, M=kc.MEM_LEN,
              dtype="bfloat16", card=card, kernel_ms=ms, plain_ms=plain_ms,
              bound_ms=bound, bound_by=by,
              library_ms=res[variant]["library_ms"],
              **{k: v for k, v in res[variant].items() if k.startswith("fp32")})
    return res


def measure_k1f_train_shape(kc, card: str) -> dict:
    """bf16 K1f at the MLE step's shape (q 128, B 128, M 1024 full, dropatt
    0.1) against its plain version, and the v1 route on the same inputs (BD
    by torch.matmul and a gather, then K2f), a yardstick the port never
    calls: does building BD inside the tile pay on this card?"""
    fwd, plain, _, _, fa, ba, kw = kc.attention_bwd_case(
        "v2", torch.bfloat16, 128, B_TRAIN, TRAIN_MEM, TRAIN_MEM, rate=0.1)
    ms, plain_ms = kc.time_in_turns(lambda: fwd(*fa, **kw),
                                    lambda: plain(*fa, **kw), iters=5)
    bound, by = kc.bound_ms(*kc.attention_work("v2", 128, B_TRAIN, TRAIN_MEM,
                                               TRAIN_MEM, False))
    v1_fwd, _ = kc.v1_route_case(fa, ba, kw)
    line = {"shape": f"q 128, B {B_TRAIN}, M {TRAIN_MEM}, bf16, dropatt 0.1",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "v1_route_ms": kc.time_ms(v1_fwd, 5),
            "v1_route": "BD = gather(qrr @ rk^T) by torch, then K2f"}
    phase("numbers.attention_v2_train_shape", card=card, **line)
    del fa, ba
    torch.cuda.empty_cache()
    return line


def measure_k2f_train_shape(kc, card: str) -> dict:
    """K2f at the shape the port routes it: the MLE step at mem 0 (q 128,
    B 128, M 0, bf16), against its plain version and SDPA's forward."""
    kernel, plain, args = kc.attention_case("v1", torch.bfloat16, 128,
                                            B_TRAIN, 0, M=0,
                                            same_length=False)
    ms, plain_ms = kc.time_in_turns(lambda: kernel(*args),
                                    lambda: plain(*args), iters=20)
    bound, by = kc.bound_ms(*kc.attention_work("v1", 128, B_TRAIN, 0, 0,
                                               False))
    fwd, _, _ = kc.sdpa_case(128, B_TRAIN, 0, 0, False)
    line = {"shape": f"q 128, B {B_TRAIN}, M 0, bf16", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": kc.time_ms(fwd, 20),
            "library_call": "scaled_dot_product_attention forward"}
    phase("numbers.attention_v1_train_shape", card=card, **line)
    del args
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

TRAIN_MEM = 1024
B_TRAIN = 128
TRAIN_OVERRIDES = {"batch_size": B_TRAIN, "max_step": 8, "log_interval": 4,
                   "eval_interval": 8}


def check_attention_bwd(kc) -> dict:
    """K1b and K2b against their plain versions, and K1f / K2f with
    dropout, at full width (H 10, dh 50), q 128: B 1 and 8 over the M /
    count grid, a reset case at B 3, and the training op-point's B 128
    (K1b at M 1024 with a full ring, K2b at M 0; dropatt 0.1); K2f / K2b
    also at ragged q 77 and 50 (klen 377 and 350)."""
    errs = {k: {} for k in ("v2", "v1", "fwd_v2", "fwd_v1")}
    op_point = {}
    cases = 0
    grid = [(M, count) for M in (0, TRAIN_MEM) for count in (0, 500, M)
            if count <= M]
    for variant in ("v2", "v1"):
        for dtype in (torch.float32, torch.bfloat16):
            for B in (1, 8):
                for M, count in dict.fromkeys(grid):
                    for rate in (0.0, 0.1):
                        res = kc.check_attention_bwd(variant, dtype, 128, B,
                                                     count, M, rate=rate)
                        cases += 1
                        if not res["ok"]:
                            fail(f"attention backward disagrees: {res}")
                        key = res["dtype"]
                        g = max(v["max_abs_err"] for v in res["grads"].values())
                        errs[variant][key] = max(errs[variant].get(key, 0.0), g)
                        errs["fwd_" + variant][key] = max(
                            errs["fwd_" + variant].get(key, 0.0),
                            res["o_max_abs_err"])
            reset = torch.tensor([0, 1, 0], device="cuda", dtype=torch.int32)
            res = kc.check_attention_bwd(variant, dtype, 128, 3, TRAIN_MEM,
                                         TRAIN_MEM, rate=0.1, reset=reset)
            cases += 1
            if not res["ok"]:
                fail(f"attention backward disagrees (reset rows): {res}")
            # the training op-point's batch: drk's splits walk 16 batches each
            M = TRAIN_MEM if variant == "v2" else 0
            res = kc.check_attention_bwd(variant, dtype, 128, B_TRAIN, M, M,
                                         rate=0.1)
            cases += 1
            if not res["ok"]:
                fail(f"attention backward disagrees (B {B_TRAIN}): {res}")
            g = max(v["max_abs_err"] for v in res["grads"].values())
            errs[variant][res["dtype"]] = max(errs[variant][res["dtype"]], g)
            errs["fwd_" + variant][res["dtype"]] = max(
                errs["fwd_" + variant][res["dtype"]], res["o_max_abs_err"])
            op_point[f"{variant}_{res['dtype']}"] = {
                k: v["max_abs_err"] for k, v in res["grads"].items()}
            del res
            torch.cuda.empty_cache()
    # K2f / K2b at ragged shapes: q 77 with an odd klen (377), q 50 with a
    # klen (350) that is no multiple of the tensor-core kernels' 64-key tiles
    for dtype in (torch.float32, torch.bfloat16):
        for q, B, M, count, sl in ((77, 3, 300, 120, True),
                                   (50, 2, 300, 300, False)):
            res = kc.check_attention_bwd("v1", dtype, q, B, count, M,
                                         rate=0.1, same_length=sl)
            cases += 1
            if not res["ok"]:
                fail(f"attention backward disagrees (ragged q {q}): {res}")
            g = max(v["max_abs_err"] for v in res["grads"].values())
            errs["v1"][res["dtype"]] = max(errs["v1"][res["dtype"]], g)
            errs["fwd_v1"][res["dtype"]] = max(errs["fwd_v1"][res["dtype"]],
                                               res["o_max_abs_err"])
    torch.cuda.synchronize()
    phase("kernels.attention_bwd", cases=cases, op_point_B=B_TRAIN,
          op_point_grad_max_abs_err=op_point, grad_max_abs_err={
        k: errs[k] for k in ("v2", "v1")}, fwd_dropout_max_abs_err={
        k: errs["fwd_" + k] for k in ("v2", "v1")},
          tol={"grads": {"float32": f"{kc.GRAD_REL_TOL_F32} * max|ref|",
                         "bfloat16": f"{kc.GRAD_REL_TOL_BF16} * max|ref|"},
               "o": {"float32": kc.ATTN_TOL_F32,
                     "bfloat16": f"{kc.ATTN_REL_TOL_BF16} * max|o|"}})
    return errs


def write_random_corpus(data_dir: str, vocab_path: str, n_train: int,
                        train_len: int, n_eval: int, eval_len: int,
                        seed: int = 0) -> None:
    """A seeded random corpus in the layout the port's ``MusicDataset``
    reads: ``vocab.txt`` (a copy of ``vocab_path``) and ``train/``,
    ``valid/``, ``test/`` folders of int32 token pieces whose lengths vary
    by up to 20% around ``train_len`` / ``eval_len``, drawn from every id but
    <S> and <PAD>. The model learns nothing from it (the CPU CLI tests use
    it too)."""
    import numpy as np
    from transformer_gan_torch.data.vocab import BaseVocab

    rng = np.random.RandomState(seed)
    vocab = BaseVocab.from_file(vocab_path)
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab.all_tokens) + "\n")
    for split, n, length in (("train", n_train, train_len),
                             ("valid", n_eval, eval_len),
                             ("test", n_eval, eval_len)):
        folder = os.path.join(data_dir, split)
        os.makedirs(folder, exist_ok=True)
        for k in range(n):
            size = int(length * rng.uniform(0.8, 1.2))
            np.save(os.path.join(folder, f"{k:05d}.npy"),
                    rng.randint(2, len(vocab), size).astype(np.int32))


def _train_cfg_file(work: str, name: str, base: str = "experiment_baseline.yml",
                    **groups) -> str:
    """A shipped training config with overrides per group (TRAIN when given
    as plain keys), written beside the corpus."""
    import yaml
    with open(os.path.join(ROOT, "training_config", base)) as f:
        cfg = yaml.safe_load(f)
    for key, value in groups.items():
        if isinstance(value, dict):
            cfg.setdefault(key, {}).update(value)
        else:
            cfg["TRAIN"][key] = value
    path = os.path.join(work, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _train_log(run_dir: str) -> dict:
    """The logged train lines (step, tokens/s, nll) and eval NLLs."""
    import re
    with open(os.path.join(run_dir, "train_rank0.log")) as f:
        text = f.read()
    steps = [{"step": int(m[0]), "tokens_per_s": float(m[1]),
              "nll": float(m[2]), "grad_norm": float(m[3])}
             for m in re.findall(r"Train Step (\d+)/\d+, lr=[\d.e-]+, "
                                 r"tokens/s=([\d.]+), nll=([\d.]+), "
                                 r"ppl=[\d.a-z]+, grad norm=([\d.]+)", text)]
    evals = [float(m) for m in re.findall(r"val nll=([\d.]+)", text)]
    tests = [float(m) for m in re.findall(r"test nll=([\d.]+)", text)]
    return {"train": steps, "val_nll": evals, "test_nll": tests}


def run_train_path(_native) -> tuple[dict, str]:
    """The training CLI on the baseline config over a seeded random corpus:
    8 steps at mem 1024 (K1f, K1b), 2 steps at mem 0 with random_crop (K2f,
    K2b), then the generation CLI on the trained run directory. Returns the
    launch counts summed over the three runs and the mem-1024 run's
    directory."""
    import math
    from transformer_gan_torch.cli import generate as gcli
    from transformer_gan_torch.cli import train as tcli
    from transformer_gan_torch.config import PACKAGED_VOCAB, inference_config

    work = os.path.join(ROOT, "build", "chip_smoke", "train")
    data = os.path.join(work, "data")
    t0 = time.perf_counter()
    write_random_corpus(data, PACKAGED_VOCAB, n_train=160, train_len=1400,
                        n_eval=11, eval_len=300, seed=0)
    corpus_s = time.perf_counter() - t0
    total = dict.fromkeys(_native.LAUNCHES, 0)
    runs = {}
    for name, train, need in (
            ("mem1024", TRAIN_OVERRIDES, ("xl_attn_fwd_v2", "xl_attn_bwd_v2",
                                          "xl_attn_fwd_v2_tc",
                                          "xl_attn_bwd_v2_tc")),
            ("mem0_random_crop", {**TRAIN_OVERRIDES, "max_step": 2,
                                  "log_interval": 1, "eval_interval": 2,
                                  "mem_length": 0, "random_crop": True},
             ("xl_attn_fwd_v1", "xl_attn_bwd_v1", "xl_attn_fwd_v1_tc",
              "xl_attn_bwd_v1_tc"))):
        cfg = _train_cfg_file(work, f"{name}.yml", **train)
        torch.cuda.synchronize()
        _native.reset_launches()
        t0 = time.perf_counter()
        trainer = tcli.main(["--data_dir", data, "--cfg", cfg, "--work_dir",
                             os.path.join(work, name)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_native.LAUNCHES)
        for k in need:
            if launches[k] == 0:
                fail(f"the training run {name} never launched {k}")
        log = _train_log(trainer.work_dir)
        if not log["train"] or not all(math.isfinite(x["nll"])
                                       for x in log["train"]):
            fail(f"training run {name} logged no finite NLL: {log}")
        runs[name] = {"run_dir": os.path.relpath(trainer.work_dir, ROOT),
                      "steps": trainer.train_step_num, "wall_s": wall,
                      "launches": launches, **log}
        for k in total:
            total[k] += launches[k]
    phase("main_path.train", corpus_write_s=corpus_s,
          overrides=TRAIN_OVERRIDES, **runs)

    icfg = inference_config()
    icfg.EVENT.vocab_file_path = PACKAGED_VOCAB
    icfg.MODEL.model_directory = os.path.join(ROOT, runs["mem1024"]["run_dir"])
    icfg.MODEL.checkpoint_name = "checkpoint_last"
    icfg.MODEL.memory_length = 1024
    icfg.OUTPUT.output_txt_directory = os.path.join(work, "generated")
    icfg.GENERATION.generation_length = 256
    icfg.INPUT.num_midi_files = 2
    torch.cuda.synchronize()
    _native.reset_launches()
    summary = gcli.main(icfg, "cuda:0",
                        torch.Generator(device="cuda:0").manual_seed(7))
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    vocab, _ = gcli.load_vocab(PACKAGED_VOCAB)
    for fp in summary["files"]:
        with open(fp) as f:
            toks = [l.strip() for l in f if l.strip()]
        if len(toks) != 256 or any(t not in vocab for t in toks):
            fail(f"{fp}: generation from the trained run is malformed")
    if len(summary["files"]) != 2 or launches["generate_chunk"] == 0:
        fail(f"generation from the trained run: {summary}, {launches}")
    for k in total:
        total[k] += launches[k]
    phase("main_path.train_generate", files=len(summary["files"]),
          tokens=summary["tokens"], launches=launches)
    return total, os.path.join(ROOT, runs["mem1024"]["run_dir"])


# Card kernel path vs CPU plain path, two fp32 steps (check_train_reference).
# The gradient is held leaf by leaf: max |g_card - g_cpu| over a parameter
# tensor, relative to that tensor's max |g_cpu| (an H100 read 4.7e-6, in
# layers.1.r_w). Parameters are held to two fp32 roundings of their value
# plus 1e-8: one step moves a weight by about lr = 0.004 x step / 4000 =
# 1e-6 whatever the gradient's size, so a wrong or missing update shows
# there, a wrong gradient magnitude only in the gradient check.
TRAIN_REF_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4,
                 "grad_leaf_rel": 2e-5, "param_rtol": 2 * 2.0 ** -23,
                 "param_atol": 1e-8, "mem_abs": 1e-3}


def measure_k1b_cnn_shape(kc, card: str) -> dict:
    """bf16 K1b at the cnn config's MLE step (q 512, B 16 a batch chunk,
    M 128 full, dropatt 0.1) against its plain version."""
    fwd, _, bwd, bwd_p, fa, ba, kw = kc.attention_bwd_case(
        "v2", torch.bfloat16, 512, 16, 128, 128, rate=0.1)
    args = ba(*fwd(*fa, **kw))
    ms, plain_ms = kc.time_in_turns(lambda: bwd(*args, **kw),
                                    lambda: bwd_p(*args, **kw), iters=10)
    bound, by = kc.bound_ms(*kc.attention_work("v2", 512, 16, 128, 128, False,
                                               backward=True))
    line = {"shape": "q 512, B 16, M 128, bf16, dropatt 0.1", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
    phase("numbers.attention_v2_bwd_cnn_shape", card=card, **line)
    return line


def measure_k1b_fp32(kc) -> dict:
    """The fp32 CUDA-core K1b, the on-card reference, against its fp32 plain
    version at q 128, B 8, M 1024 full, dropatt 0.1."""
    fwd, _, bwd, bwd_p, fa, ba, kw = kc.attention_bwd_case(
        "v2", torch.float32, 128, 8, TRAIN_MEM, TRAIN_MEM, rate=0.1)
    args = ba(*fwd(*fa, **kw))
    ms, plain_ms = kc.time_in_turns(lambda: bwd(*args, **kw),
                                    lambda: bwd_p(*args, **kw), iters=5)
    bound = kc.bound_ms(*kc.attention_work("v2", 128, 8, TRAIN_MEM, TRAIN_MEM,
                                           False, backward=True, es=4),
                        "float32")[0]
    return {"fp32_shape": f"q 128, B 8, M {TRAIN_MEM}, fp32, dropatt 0.1",
            "fp32_ms": ms, "fp32_plain_ms": plain_ms, "fp32_bound_ms": bound}


def check_train_reference() -> dict:
    """Two MLE steps at full width in fp32 (B 2, tgt 128, mem 256, dropout
    0, a reset row in step 2): the kernel path on the card against the plain
    path on the CPU, same batches and weights. Per step: the loss, the
    pre-clip grad norm and every gradient leaf; after the steps the
    parameters and the new memories (atol 1e-3: six layers, the kernel
    check's K/V bound). Tolerances: ``TRAIN_REF_TOL``; the grad norm's rtol
    allows for fp32 sums in another order over 13.7M gradients."""
    from transformer_gan_torch import kernel_check as kc

    B, tgt, M = 2, 128, 256
    gen = torch.Generator().manual_seed(3)
    batches = [(torch.randint(2, 310, (1, tgt, B), generator=gen),
                torch.randint(2, 310, (1, tgt, B), generator=gen),
                torch.tensor([[False, i == 1]])) for i in range(2)]
    out = {}
    for device in ("cuda:0", "cpu"):
        case = kc.TrainCase(B=B, tgt=tgt, M=M, dtype="float32", dropout=0.0,
                            device=device)
        mets, grads = [], []
        for d, t, r in batches:
            d, t, r = d.to(device), t.to(device), r.to(device)
            grads.append(case.flat_grad(d, t, r).cpu())
            case.state, met = case.fn(case.state, d, t, r)
            mets.append({k: float(v) for k, v in met.items()})
        out[device] = (mets, grads, case.state.flat.detach().cpu(),
                       case.state.mems[0].hids.cpu())
    layout = case.state.layout
    (mk, gk, pk, hk), (mp, gp, pp, hp) = out["cuda:0"], out["cpu"]
    tol = TRAIN_REF_TOL
    loss_rel = max(abs(a["loss_weighted"] - b["loss_weighted"])
                   / abs(b["loss_weighted"]) for a, b in zip(mk, mp))
    gn_rel = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                 for a, b in zip(mk, mp))
    # the step's own grad norm must be the norm of the gradient compared
    # (summed as the step sums it: torch's fp32 norm() of 13.7M entries
    # is 3e-4 off on the CPU)
    gn_self = max(abs(float(g.square().sum().sqrt()) - m["grad_norm"])
                  / m["grad_norm"] for g, m in zip(gk + gp, mk + mp))
    leaf_rel, worst = 0.0, None
    for g_k, g_p in zip(gk, gp):
        for name, off, shp in zip(layout.names, layout.offsets,
                                  layout.shapes):
            n = 1
            for s in shp:
                n *= s
            a, b = g_k[off:off + n], g_p[off:off + n]
            rel = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            if rel > leaf_rel:
                leaf_rel, worst = rel, name
    p_excess = float(((pk - pp).abs() - tol["param_rtol"] * pp.abs()).max())
    p_err = float((pk - pp).abs().max())
    m_err = float((hk - hp).abs().max())
    return {"loss_rel_err": loss_rel, "grad_norm_rel_err": gn_rel,
            "grad_norm_self_rel_err": gn_self,
            "grad_leaf_max_rel_err": leaf_rel, "grad_worst_leaf": worst,
            "param_max_abs_err": p_err,
            "param_max_err_beyond_rtol": p_excess, "mem_max_abs_err": m_err,
            "kernel_loss": [m["loss_weighted"] for m in mk],
            "plain_loss": [m["loss_weighted"] for m in mp], "tol": tol,
            "ok": (loss_rel <= tol["loss_rel"]
                   and gn_rel <= tol["grad_norm_rel"]
                   and gn_self <= tol["grad_norm_rel"]
                   and leaf_rel <= tol["grad_leaf_rel"]
                   and p_excess <= tol["param_atol"]
                   and m_err <= tol["mem_abs"])}


def measure_train(kc, card: str) -> dict:
    """bf16 at the training op-point (B 128, tgt 128, mem 1024): training
    tokens/s of the kernel path against the plain path (the attention
    routed to models/attention.rel_attention_kv), and the attention
    kernels' forward + backward per layer call against their plain
    versions. Timed in turns (plain, kernel, kernel, plain)."""
    res = {}
    B, tgt = TRAIN_OVERRIDES["batch_size"], 128
    for variant, M in (("v2", TRAIN_MEM), ("v1", 0)):
        fwd, fwd_p, bwd, bwd_p, fa, ba, kw = kc.attention_bwd_case(
            variant, torch.bfloat16, tgt, B, M, M, rate=0.1)
        o, m, l = fwd(*fa, **kw)
        args = ba(o, m, l)
        iters = 5 if variant == "v2" else 20
        pair = kc.time_in_turns(lambda: bwd(*ba(*fwd(*fa, **kw)), **kw),
                                lambda: bwd_p(*ba(*fwd_p(*fa, **kw)), **kw),
                                iters=iters)
        b_ms = kc.time_in_turns(lambda: bwd(*args, **kw),
                                lambda: bwd_p(*args, **kw), iters=iters)
        shape = f"q {tgt}, B {B}, M {M}, bf16, dropatt 0.1"
        bound, by = kc.bound_ms(*kc.attention_work(variant, tgt, B, M, M,
                                                   False, backward=True))
        key = "bwd_v2_tc" if variant == "v2" else "bwd_v1"
        res[key] = {"ms": b_ms[0], "plain_ms": b_ms[1], "bound_ms": bound,
                    "bound_by": by, "library_ms": None, "shape": shape,
                    "library_call": "none: the position term comes from rk "
                    "inside the kernel"}
        lib = lib_pair = v1_pair = None
        if variant == "v2":
            _, v1_fwd_bwd = kc.v1_route_case(fa, ba, kw)
            v1_pair = kc.time_ms(v1_fwd_bwd, iters)
            cnn = measure_k1b_cnn_shape(kc, card)
            res["bwd_v2_tc"].update(
                fwd_bwd_ms=pair[0], fwd_bwd_plain_ms=pair[1],
                v1_route_fwd_bwd_ms=v1_pair,
                v1_route="BD by torch.matmul + gather, K2f + K2b, dqrr and "
                         "drk from dbd by scatter + matmul (a yardstick)",
                other_shapes=[cnn])
            res["bwd_v2"] = dict(cnn, library_ms=None,
                                 library_call=res[key]["library_call"],
                                 **measure_k1b_fp32(kc))
        if variant == "v1":
            _, fwd_bwd, sdpa_bwd = kc.sdpa_case(tgt, B, M, M, False)
            lib_pair = kc.time_ms(fwd_bwd, 20)
            lib = kc.time_ms(sdpa_bwd, 20)
            res["bwd_v1"].update(
                library_ms=lib, fwd_bwd_ms=pair[0],
                library_fwd_bwd_ms=lib_pair, library_call=(
                    "scaled_dot_product_attention backward alone "
                    "(torch.autograd.grad on a kept forward) at dropout 0; "
                    "library_fwd_bwd_ms: its forward + backward against "
                    "K2f + K2b's fwd_bwd_ms"))
        phase(f"numbers.train_attention_{variant}", q=tgt, B=B, M=M,
              dtype="bfloat16", card=card, fwd_bwd_ms=pair[0],
              fwd_bwd_plain_ms=pair[1], bwd_ms=b_ms[0],
              bwd_plain_ms=b_ms[1], bwd_bound_ms=bound, bound_by=by,
              sdpa_bwd_ms=lib, sdpa_fwd_bwd_ms=lib_pair,
              v1_route_fwd_bwd_ms=v1_pair)
        del o, m, l, args
    torch.cuda.empty_cache()

    case = kc.TrainCase(B=B, tgt=tgt, M=TRAIN_MEM)
    case.steps(6)         # warm-up, and fills the 1024-slot memory:
    case.steps(2, plain=True)  # every timed step sees a full ring
    torch.cuda.reset_peak_memory_stats()
    turns = [case.steps(3, plain=True), case.steps(3), case.steps(3),
             case.steps(3, plain=True)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k_s, p_s = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    tokens = case.tokens
    phase("numbers.train", B=B, tgt=tgt, M=TRAIN_MEM, dtype="bfloat16",
          dropout=0.1, card=card, kernel_step_s=k_s, plain_step_s=p_s,
          kernel_tokens_per_s=tokens / k_s, plain_tokens_per_s=tokens / p_s,
          turns_s=turns, peak_gib=peak)
    return res



# ---------------------------------------------------------------------------
# GAN
# ---------------------------------------------------------------------------

def check_gan_attention(kc) -> dict:
    """K1f / K1b at the GAN config's MLE shape (q 512, M 128 full, B 64,
    dropatt 0.1 as trained) and the same_length window without memory,
    where every key of a row is masked (K1f/K1b and K2f/K2b, B 8)."""
    errs = {k: {} for k in ("v2", "v1", "fwd_v2", "fwd_v1")}

    def keep(variant, res):
        key = res["dtype"]
        g = max(v["max_abs_err"] for v in res["grads"].values())
        errs[variant][key] = max(errs[variant].get(key, 0.0), g)
        errs["fwd_" + variant][key] = max(errs["fwd_" + variant].get(key, 0.0),
                                          res["o_max_abs_err"])

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        res = kc.check_attention_bwd("v2", dtype, 512, 64, 128, 128, rate=0.1)
        cases.append({k: res[k] for k in ("variant", "dtype", "q", "B", "M",
                                          "max_abs_err", "ok")})
        if not res["ok"]:
            fail(f"K1f / K1b disagree at q 512, M 128, B 64: {res}")
        keep("v2", res)
        del res
        torch.cuda.empty_cache()
        for variant in ("v2", "v1"):
            for q in (128, 37):
                fwd = kc.check_attention(variant, dtype, q, 8, 0, M=0,
                                         same_length=True)
                res = kc.check_attention_bwd(variant, dtype, q, 8, 0, 0,
                                             same_length=True)
                cases.append({"variant": variant, "dtype": res["dtype"],
                              "q": q, "M": 0, "same_length": True,
                              "fwd_err": fwd["max_abs_err"],
                              "max_abs_err": res["max_abs_err"],
                              "ok": fwd["ok"] and res["ok"]})
                if not (fwd["ok"] and res["ok"]):
                    fail(f"same_length M 0 window disagrees: {fwd} {res}")
                keep(variant, res)
    phase("kernels.attention_gan", cases=cases)
    return errs


def check_decode(kc) -> dict:
    """K4 and K5 against their plain versions at full width, M 64: fp32 and
    bf16, B 8 and 64, count 0, 30 and 64, chunks of 32 then 27 tokens."""
    errs = {"K4": {}, "K5": {}}
    for dtype in ("float32", "bfloat16"):
        for B in (8, 64):
            for count in (0, 30, kc.GAN_MEM):
                for step in (False, True):
                    res = kc.check_decode(dtype, B, count, step=step)
                    if not res["ok"]:
                        fail(f"GAN sampler kernel disagrees: {res}")
                    key = res["kernel"]
                    errs[key][dtype] = max(errs[key].get(dtype, 0.0),
                                           res["max_abs_err"])
                    phase("kernels.decode", **{
                        k: res[k] for k in ("kernel", "dtype", "B", "count",
                                            "ok", "max_abs_err")},
                        chunks=[{k: c[k] for k in c
                                 if k != "first_divergence"}
                                for c in res["chunks"]])
    return errs


def check_chain(kc) -> dict:
    """K6 and K7 against the plain chain at full width: n 59, M 64, fp32
    and bf16, B 8 and 64, count 0 and 64, T 1.0 and 0.5."""
    errs = {"K6": {}, "K7": {}}
    for dtype in ("float32", "bfloat16"):
        for B in (8, 64):
            for count in (0, kc.GAN_MEM):
                for T in (1.0, 0.5):
                    res = kc.check_chain(dtype, B, count, T)
                    phase("kernels.chain_bwd", **res)
                    if not res["ok"]:
                        fail(f"chain backward kernel disagrees: {res}")
                    for key in ("K6", "K7"):
                        errs[key][dtype] = max(errs[key].get(dtype, 0.0),
                                               res[key])
                    torch.cuda.empty_cache()
    return errs


B_GAN = 64
GAN_OVERRIDES = {"batch_size": B_GAN, "max_step": 3, "log_interval": 1,
                 "eval_interval": 3}


def _gan_log(run_dir: str) -> list:
    import re
    with open(os.path.join(run_dir, "train_rank0.log")) as f:
        text = f.read()
    return [{"step": int(m[0]), "nll": float(m[1]), "gen_loss": float(m[2]),
             "dis_loss": float(m[3])}
            for m in re.findall(r"Train Step (\d+)/\d+, .*?nll=([\d.]+), .*?"
                                r"gen_loss=([-\d.]+), dis_loss=([-\d.]+)", text)]


def run_gan_path(_native, mle_run: str) -> dict:
    """The training CLI on experiment_cnn.yml (batch 64, warm start from the
    MLE run, dis and gen phases at steps 1 and 2), then --restart for a
    third (K4, K6); a second run on the per-token sampler and the
    recomputing chain (K5, K7). Returns the launch counts of the runs."""
    from transformer_gan_torch.cli import train as tcli
    from transformer_gan_torch.train import checkpoint as ckpt
    work = os.path.join(ROOT, "build", "chip_smoke", "gan")
    os.makedirs(work, exist_ok=True)
    data = os.path.join(ROOT, "build", "chip_smoke", "train", "data")
    warm = os.path.join(mle_run, "checkpoint_last")
    disc = {"dis_loss_freq": 1, "gen_loss_freq": 1}
    total = dict.fromkeys(_native.LAUNCHES, 0)
    runs = {}
    for name, tpu, env, need in (
            ("chunk_res", {}, None, ("decode_chunk", "chain_bwd_res",
                                     "xl_attn_fwd_v2", "xl_attn_bwd_v2",
                                     "xl_attn_fwd_v2_tc",
                                     "xl_attn_bwd_v2_tc")),
            ("step_recompute", {"gan_chain_bwd": "kernel_recompute"}, "0",
             ("decode_step", "chain_bwd_recompute"))):
        cfg = _train_cfg_file(work, f"{name}.yml", "experiment_cnn.yml",
                              **GAN_OVERRIDES, load_from_previous=warm,
                              DISCRIMINATOR=disc, TPU=tpu)
        if env is not None:
            os.environ["TGTPU_CHUNK_SAMPLER"] = env
        torch.cuda.synchronize()
        _native.reset_launches()
        t0 = time.perf_counter()
        try:
            tr = tcli.main(["--data_dir", data, "--cfg", cfg, "--work_dir",
                            os.path.join(work, name)])
            launches = dict(_native.LAUNCHES)
            restart = None
            if name == "chunk_res":
                counts = (tr.gan.dis_opt_state.count,
                          tr.gan.gen_opt_state.count)
                cfg4 = _train_cfg_file(work, f"{name}_4.yml",
                                       "experiment_cnn.yml",
                                       **{**GAN_OVERRIDES, "max_step": 4},
                                       load_from_previous=warm,
                                       DISCRIMINATOR=disc, TPU=tpu)
                _native.reset_launches()
                again = tcli.main(["--data_dir", data, "--cfg", cfg4,
                                   "--work_dir", tr.work_dir, "--restart"])
                restart = {"steps": again.train_step_num,
                           "dis_updates": [counts[0],
                                           again.gan.dis_opt_state.count],
                           "gen_updates": [counts[1],
                                           again.gan.gen_opt_state.count]}
                if (again.gan.gen_opt_state.count != counts[1] + 1
                        or again.gan.dis_opt_state.count
                        != counts[0] + tr.cfg.DISCRIMINATOR.dis_steps):
                    fail(f"--restart lost the GAN state: {restart}")
                launches = {k: launches[k] + _native.LAUNCHES[k]
                            for k in launches}
        finally:
            os.environ.pop("TGTPU_CHUNK_SAMPLER", None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k in need:
            if launches[k] == 0:
                fail(f"the GAN run {name} never launched {k}")
        log = _gan_log(tr.work_dir)
        if (len(log) < 3 or not all(abs(x["gen_loss"]) > 0 and abs(x["dis_loss"])
                                    > 0 for x in log[1:])):
            fail(f"the GAN run {name} logged no gen / dis losses: {log}")
        if ckpt.load_gan_payload(tr.work_dir, "checkpoint_last") is None:
            fail(f"the GAN run {name} checkpointed no GAN state")
        runs[name] = {"run_dir": os.path.relpath(tr.work_dir, ROOT),
                      "steps": tr.train_step_num, "wall_s": wall,
                      "launches": launches, "log": log, "restart": restart}
        for k in total:
            total[k] += launches[k]
    phase("main_path.gan", overrides=GAN_OVERRIDES, discriminator=disc,
          warm_start=os.path.relpath(warm, ROOT), **runs)
    return total


def measure_gan(kc, card: str) -> dict:
    """bf16 at the GAN op-point (B 64, M 64, 59 sampled tokens): the dis
    phase (5 updates) and the gen phase in ms, and sampled tokens/s, of the
    kernel path against the plain path (the sampler and chain plain
    versions on the card) in turns; then each of K4, K5, K6 and K7 per
    launch against its plain version, beside its bound."""
    from transformer_gan_torch.models import gan as gan_mod
    res = {}
    cases = {r: kc.GanCase("bfloat16", B_GAN, "cuda", route=r, dis_steps=5,
                           host_draws=False)
             for r in ("plain", "kernel")}

    def phase_s(route, which):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(cases[route].phases, which + "_phase")(1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def sample_s(route):
        ph = cases[route].phases
        data = ph._next_dis_batch()[0]
        draws = ph._draws()
        noise = [draws.gumbel(c, n, B_GAN, 310)
                 for c, n in enumerate(ph.gcfg.chunk_lengths())]
        params = cases[route].state.params()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gan_mod._sample_fake_chunks_fused(params, ph.xcfg, ph.gcfg, data, noise)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for route in ("plain", "kernel"):       # warm-up
        phase_s(route, "dis"), phase_s(route, "gen"), sample_s(route)
    timed = {}
    for which, fn in (("dis", phase_s), ("gen", phase_s), ("sample", None)):
        f = (lambda r: phase_s(r, which)) if fn else sample_s
        turns = [f("plain"), f("kernel"), f("kernel"), f("plain")]
        timed[which] = {"kernel_ms": (turns[1] + turns[2]) / 2 * 1e3,
                        "plain_ms": (turns[0] + turns[3]) / 2 * 1e3,
                        "turns_s": turns}
    toks = cases["kernel"].tokens_per_pass()
    timed["sample"].update(
        tokens=toks,
        kernel_tokens_per_s=toks / (timed["sample"]["kernel_ms"] / 1e3),
        plain_tokens_per_s=toks / (timed["sample"]["plain_ms"] / 1e3))
    phase("numbers.gan", B=B_GAN, M=kc.GAN_MEM, dtype="bfloat16", card=card,
          dis_phase=timed["dis"], gen_phase=timed["gen"],
          sampling=timed["sample"])
    del cases
    torch.cuda.empty_cache()

    case = kc.DecodeCase("bfloat16", B_GAN, kc.GAN_MEM)
    g = case.noise(32)
    ms, plain_ms = kc.time_in_turns(lambda: case.run(32, g),
                                    lambda: case.run(32, g, plain=True), 5)
    bound, by = kc.bound_ms(*kc.sampler_work(32, B_GAN, kc.GAN_MEM,
                                             kc.GAN_MEM))
    no_lib = "none computes the gumbel sampler through the decoder"
    res["K4"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": by, "library_ms": None, "library_call": no_lib,
                 "shape": f"32 tokens, B {B_GAN}, M {kc.GAN_MEM}, bf16"}
    L, _, H, B, _, dh = case.kv.shape
    staged = torch.zeros((L, 2, H, B, 32, dh), dtype=case.kv.dtype,
                         device=case.kv.device)

    def step(plain):
        fn = (case.ops.fused_decode_step_plain if plain
              else case.ops.fused_decode_step)
        return fn(case.stacked, case.cfg, case.kv, case.R, staged, case.ids,
                  g[5], 5, case.count)

    ms, plain_ms = kc.time_in_turns(lambda: step(False), lambda: step(True), 20)
    bound, by = kc.bound_ms(*kc.sampler_work(1, B_GAN, kc.GAN_MEM, kc.GAN_MEM,
                                             t0=5))
    res["K5"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": by, "library_ms": None, "library_call": no_lib,
                 "shape": f"1 token at step 5, B {B_GAN}, M {kc.GAN_MEM}, bf16"}
    del case, staged
    chain = kc.ChainCase("bfloat16", B_GAN, kc.GAN_MEM)
    for key, variant, recompute in (("K6", "res", False),
                                    ("K7", "recompute", True)):
        ms, plain_ms = kc.time_in_turns(lambda: chain.run(variant),
                                        lambda: chain.run("plain"), 2)
        bound, by = kc.bound_ms(*kc.chain_work(chain.n, B_GAN, kc.GAN_MEM,
                                               kc.GAN_MEM, recompute))
        res[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": None,
                    "library_call": "none computes the straight-through "
                    "chain's backward", "shape": f"n {chain.n}, B {B_GAN}, "
                    f"M {kc.GAN_MEM}, count {kc.GAN_MEM}, bf16"}
    phase("numbers.gan_kernels", card=card,
          **{k: res[k] for k in ("K4", "K5", "K6", "K7")})
    return res


if __name__ == "__main__":
    main()
