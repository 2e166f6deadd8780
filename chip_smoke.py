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
   gumbel sampler (K4, K5) and its reverse chain (K6, K7) at M 64; bf16 K3,
   K4 and K5 run the split-key, lane-tiled decode chain
   (csrc/decode_chain_tc.cuh) and are held against the plain versions with
   the kernel's key splits and without (the phase prints the splits and
   the route: lane groups at B >= 8 where the keys are split and the
   grouped grid fills the card); bf16 K3 at the metrics eval's wave (B 32,
   M 2048, counts 0 to 2016) on the lane-grouped decode attention, each
   call counted in generate_chunk_grouped, and K4 / K5 at the GAN's
   shapes, which stay off it, and at B 8, M 1024, which takes it, each
   launch counted (kernels.generate_grouped, with its seconds); bf16
   K6 and K7 run the reverse chain of csrc/chain_bwd_tc.cu on the same
   GEMV engine (post-norm, and one pre-norm case);
4. main path, generation: ``transformer_gan_torch.cli.generate.main`` on
   seeded full-width bf16 parameters, unconditional (8 lanes) and
   conditional with the debug incremental == batch memory check, with
   launch counters showing the kernels of the path ran (K1f on the tensor
   cores, K3 on the bf16 decode chain); then the kernel
   path against the CPU plain path on a short full-width fp32 slice;
5. main path, training: ``transformer_gan_torch.cli.train`` on
   experiment_baseline.yml (batch 128) over a seeded random corpus for 8
   steps with an eval and checkpoints (K1f, K1b, bf16 on the tensor
   cores), a 2-step run at TRAIN.mem_length 0 with random_crop (K2f, K2b),
   the generation CLI on
   the trained run directory, and two fp32 full-width training steps of the
   kernel path against the CPU plain path; then the MIDI-to-MIDI pipeline
   (main_path.codec): ``tools.make_synth_corpus`` writes 200 / 24 / 24
   structured pieces as MIDI, ``cli.encode`` turns them into a data
   directory on the native encoder (the train split's 35-way grid), held
   bit-exact against the pure-Python encoder on 4 pieces x 35 and the valid
   split, ``cli.train`` trains 500 steps on it (K1f, K1b; the val NLL
   beside the corpus's unigram entropy), ``cli.batch_generate`` samples
   4096 tokens at M 4146 from a valid prefix and unconditionally under
   topk and random (K1f, K3), and each MIDI file it writes re-encodes to a
   decode -> encode fixed point within 5 passes;
6. main path, GAN: ``transformer_gan_torch.cli.train`` on
   experiment_cnn.yml (batch 64, warm start from the training run) with a
   dis and a gen phase at steps 1 and 2 and a restart (K4, K6), a second run
   on the per-token sampler and the recomputing chain (K5, K7), both chains
   on the bf16 reverse chain (its "_tc" counters), and one
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
   versions. The decode chain: the bf16 chain's K3 (B 1 and 8, M 4146),
   K4 (B 64, M 64) and K5 (step 5) beside the fp32 chain, the on-card
   reference, at the same shapes; K3 at B 1 and 8 on both routes of the
   decode attention (ms_by_route); K3's streaming floor beside its bound;
   one K3 and one K4 call traced (torch.profiler) for the kernel launches
   a token and the device-busy share (the union of the kernels' intervals
   over their span and over the traced call). The reverse chain: bf16 K6
   and K7 (n 59, B 64, M 64) beside the fp32 chain, the on-card reference,
   K6's streaming floor beside its bound, one K6 and one K7 call traced
   (profile_chain) for launches a token and the busy share;
8. PPO and the quality metrics: K3 on the metrics' gumbel-argmax route
   (same_length off) against its plain version at B 8, 16 and 32, M 2048,
   counts 0, 32 and 2016 (kernels.generate_gumbel); the training CLI on
   experiment_spanbert.yml under ppo (dis_D a second BERT from the MLM
   checkpoint), 3 steps and a restart (main_path.ppo), and the fp32 PPO
   update (dis, classifier, gen) of the card's kernel path against the
   CPU's plain path, the generator at REF_LAYERS (3) of its 6 layers, as
   for the spanbert update (check.ppo_update); the training CLI's eval with BLEU,
   self-BLEU and the classifier on at gen_seq_len 2048 (64 / 256 / 64
   samples; main_path.metrics; bert_score's CLI runs in phase 10 on the
   pieces ``tools.gen_npy_samples`` writes from this run, as
   main_path.bert_score); then the PPO phases' ms, kernel and plain path
   in turns (numbers.gan_ppo), and the metrics' generated tokens/s by wave
   width, K3's gumbel chunk against its plain version and bound, the eval's
   seconds by part and at the shipped 640 / 2560 / 256 samples
   (numbers.metrics);
9. main path, data parallel (main_path.data_parallel): the training CLI
   under ``torchrun --nproc_per_node 1`` (NCCL, world 1) for 10 steps, an
   eval and a --restart for 10 more, bitwise equal to the CLI without
   torchrun; two gloo ranks sharing the card (NCCL refuses two ranks on one
   device) each take 64 rows of two fp32 MLE steps at the global B 128 and
   32 of a cnn dis and gen update at the global B 64, held against one
   process on the same global batches; K1f, K1b, K4 / K5 and K6 / K7 must
   launch on each rank; on a machine with N > 1 cards also the CLI under
   ``torchrun --nproc_per_node N`` (B 128 a card, a restart) and N NCCL
   ranks, one a card, held against one process as the two are; then the
   bf16 MLE step's ms at one rank, at two sharing the card (and at N, one a
   card) and one all-reduce of the flat fp32 gradient on gloo and on NCCL
   (numbers.data_parallel);
10. main path, the config variants (main_path.variants), each run with the
   launch counts the JAX package's routes give it: note-status inputs
   (``cli.train`` on experiment_baseline.yml, B 128, 8 steps, an eval and a
   restart on K1f / K1b; ``cli.generate`` from its run directory with both
   inference configs, 256 tokens at M 4146: K1f at the prime, no K3, which
   takes no status inputs; two fp32 MLE steps with status, card against
   CPU); the raw-hidden memory (``TPU.cache_kv: false``: 4 steps and an
   eval, generation as above with the conditional run's incremental ==
   batch check, the cnn GAN on the rolling sampler; no kernel launches; one
   fp32 MLE step and one cnn dis and gen update, card against CPU); remat
   (5 steps at dropout 0, the logged losses equal to a run without it);
   ``TPU.profile_dir`` (16 steps, the trace holds K1f's and K1b's kernels);
   ``tools.gen_npy_samples`` on the metrics run at its defaults (16 x 2048,
   wave 4; K3) and bert_score on its directory;
11. the trajectory tools (check.trajectory): ``tools.convergence_parity``
   at the baseline widths (2 layers, B 32, tgt 128, M 256), 150 steps and
   an eval every 50 from one set of weights on one stream, the fp32 kernel
   route (K1f, K1b) and the bf16 kernel route against the fp32 plain
   route, each within its band, and a control (warmup 0) that must leave
   the bf16 band; ``tools.gan_parity`` on the cached layout at the cnn
   widths (2 layers, B 16, M 64), 6 dis + gen phase pairs on recorded
   batches and uniforms, the fp32 kernel route (K4, K6) and the fp32
   per-token sampler with the recomputing chain (K5, K7) against the fp32
   plain route (every logged loss within its band, the weights by the
   drift rule), the bf16 kernel route's losses recorded; every run's
   launches read, zeros included (the plain routes launch nothing);
12. numbers, as listed under 7 and 8, and the variants' (numbers.variants:
   the bf16 MLE step on the cache, on raw memory, with note status and with
   remat, each with its peak memory; generation us/token at M 4146, K3
   against the raw memory's rolling loop).

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
START = time.perf_counter()


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, **fields) -> None:
    """One JSON line; ``t_s``: seconds since the script started."""
    print(json.dumps({"phase": name,
                      "t_s": round(time.perf_counter() - START, 1), **fields},
                     default=str), flush=True)


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
    from transformer_gan_torch.ops import generate as gen_ops
    decode_points = ((1, kc.MEM_LEN), (8, kc.MEM_LEN), (32, METRICS_SEQ),
                     (B_GAN, kc.GAN_MEM), (32, 128), (8, 128))
    routes = {f"B {B}, M {M}": gen_ops.chain_route(10, B, M + 32, dev)
              for B, M in decode_points}
    phase("kernels.decode_chain",
          design={str(d).split(".")[-1]: gen_ops.chain_design(d)
                  for d in (torch.float32, torch.bfloat16)},
          lane_group_and_key_splits=routes,
          launches_per_token_by_design={
              k: kc.chain_launches_per_token(6, S, G)
              for k, (G, S) in routes.items()})
    # K4's GAN shapes keep split_attn_kernel; evalgen's takes lane groups
    if (routes[f"B {B_GAN}, M {kc.GAN_MEM}"][0] or routes["B 32, M 128"][0]
            or routes["B 8, M 128"][0]
            or not routes[f"B 32, M {METRICS_SEQ}"][0]):
        fail(f"decode attention routes: {routes}")
    grouped_errs = check_generate_grouped(kc)
    dec_errs = check_decode(kc)
    from transformer_gan_torch.ops import chain_bwd as chain_ops
    phase("kernels.reverse_chain",
          design={str(d).split(".")[-1]: chain_ops.chain_design(d)
                  for d in (torch.float32, torch.bfloat16)},
          launches_per_token_by_design={
              "K6": kc.chain_bwd_launches_per_token(6, False),
              "K7": kc.chain_bwd_launches_per_token(6, True)})
    chain_errs = check_chain(kc)
    span_errs = check_spanbert_shapes(kc)
    gumbel_errs = check_generate_gumbel(kc)
    torch.cuda.synchronize()

    # 4. main path, generation, through the CLI
    summaries = run_main_path(_native)
    slice_ref = check_slice_reference()
    phase("main_path.reference", **slice_ref)
    if not slice_ref["ok"]:
        fail("kernel path and CPU plain path disagree on the reference slice")

    # 5. main path, training, through the CLI
    train_launches, mle_run = run_train_path(_native)
    codec_launches = run_codec_path(_native)
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

    # 7. main path, BERT pretraining and the spanbert GAN, through the CLIs
    bert_ckpt = run_bert_pretrain(_native)
    span_launches = run_gan_bert_path(_native, mle_run, bert_ckpt)
    span_ref = kc.check_gan_reference(**ref_depth(spanbert_case(bert_ckpt)))
    phase("main_path.gan_bert_reference", generator_layers=REF_LAYERS,
          **span_ref)
    if not span_ref["ok"]:
        fail("kernel path and CPU plain path disagree on the spanbert GAN "
             "updates")

    # 8. main path, PPO at the spanbert op-point, and the quality metrics
    ppo_launches = run_ppo_path(_native, mle_run, bert_ckpt)
    ppo_ref = kc.check_gan_reference(**ref_depth(ppo_case(bert_ckpt)))
    phase("check.ppo_update", generator_layers=REF_LAYERS, **ppo_ref)
    if not ppo_ref["ok"]:
        fail("kernel path and CPU plain path disagree on the PPO updates")
    metrics_launches, metrics_run, metrics_res = run_metrics_path(
        _native, mle_run, bert_ckpt)

    # 9. main path, data parallel: torchrun at world 1, two ranks on the card
    dp_launches = run_data_parallel_path(_native, card)

    # 10. main path, the config variants (bert_score on gen_npy_samples)
    variant_launches = run_variants_path(_native, mle_run, metrics_run,
                                         bert_ckpt)

    # 11. the trajectory tools, kernel route against plain route
    traj_launches = run_trajectory_check(_native)

    # 12. numbers
    numbers = measure(kc, card)
    numbers.update(measure_train(kc, card))
    numbers.update(measure_gan(kc, card))
    numbers.update(measure_gan_bert(kc, card, bert_ckpt))
    measure_gan_ppo(kc, card, bert_ckpt)
    numbers.update(measure_metrics(kc, card, mle_run, metrics_res))
    measure_bert_pretrain(card)
    measure_variants(kc, card)
    trace = numbers["traces"]["K4"]
    numbers["K4_tc"].update(
        launches_per_token_traced=trace["launches_per_token"],
        busy_share_traced=trace["busy_share"],
        busy_share_call_traced=trace["busy_share_call"])
    paths = {"generate": summaries["launches"], "train": train_launches,
             "codec": codec_launches,
             "gan": gan_launches, "gan_bert": span_launches,
             "ppo": ppo_launches, "metrics": metrics_launches,
             "data_parallel": dp_launches, "variants": variant_launches,
             "trajectory": traj_launches}
    launches = {k: sum(p[k] for p in paths.values()) for k in _native.LAUNCHES}
    by_path = {k: {n: p[k] for n, p in paths.items()} for k in _native.LAUNCHES}

    def entry(name, source, replaces, key, f32, bf16, num, path=None):
        """``path``: count the launches of that main path alone."""
        e = {"name": name, "route": "cuda",
             "source": f"transformer_gan_torch/csrc/{source}",
             "replaces": replaces,
             "launches": launches[key] if path is None else by_path[key][path],
             "launches_by_path": by_path[key], "max_abs_err": f32,
             "max_abs_err_bf16": bf16, "ms": num["ms"],
             "plain_ms": num["plain_ms"], "bound_ms": num["bound_ms"],
             "bound_by": num["bound_by"],
             "library_ms": num.get("library_ms"),
             "library_call": num.get("library_call"),
             "shape": num.get("shape")}
        if key.startswith("xl_attn") and key + "_tc" in launches:
            # bf16 K1 / K2 run on the tensor cores
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
        # K3 / K4 / K5: every call enters generate.cu / decode.cu, which run
        # fp32 on the reference chain of decode_chain.cuh and send bf16 to
        # the chain of decode_chain_tc.cuh; these entries time the bf16
        # calls at the op-points (as in earlier runs) and carry the fp32
        # chain's times ("fp32_" keys); the "_tc" entries time the same bf16
        # calls and add the traced launches a token and busy shares
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
        # K6 / K7: every call enters chain_bwd.cu, which runs fp32 on its
        # CUDA-core chain and sends bf16 to chain_bwd_tc.cu; the two entries
        # above time the bf16 calls (as in earlier runs) and carry the fp32
        # chain's times ("fp32_" keys), these the same bf16 calls
        entry("chain_bwd_res_tc (K6, bf16 reverse chain)", "chain_bwd_tc.cu",
              "transformer_gan_tpu/ops/pallas_chain_bwd.py:301",
              "chain_bwd_res_tc", *(worst([chain_errs["K6"]])[1],) * 2,
              numbers["K6_tc"]),
        entry("chain_bwd_recompute_tc (K7, bf16 reverse chain)",
              "chain_bwd_tc.cu",
              "transformer_gan_tpu/ops/pallas_chain_bwd.py:103",
              "chain_bwd_recompute_tc", *(worst([chain_errs["K7"]])[1],) * 2,
              numbers["K7_tc"]),
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
        entry("generate_chunk_tc (K3, bf16 decode chain)",
              "decode_chain_tc.cuh",
              "transformer_gan_tpu/ops/pallas_generate.py:105",
              "generate_chunk_tc", *(errs["gen"]["bfloat16"],) * 2,
              numbers["gen_tc"]),
        entry("decode_chunk_tc (K4, bf16 decode chain)", "decode_chain_tc.cuh",
              "transformer_gan_tpu/ops/pallas_decode.py:359",
              "decode_chunk_tc", *(worst([dec_errs["K4"]])[1],) * 2,
              numbers["K4_tc"]),
        entry("decode_step_tc (K5, bf16 decode chain)", "decode_chain_tc.cuh",
              "transformer_gan_tpu/ops/pallas_decode.py:82",
              "decode_step_tc", *(worst([dec_errs["K5"]])[1],) * 2,
              numbers["K5_tc"]),
    ]
    # the spanbert op-point's shapes (B 32, M 128; the MLE step at B 32 a
    # batch chunk), launches from the spanbert GAN runs alone; the PPO run
    # (the same shapes) counts its own under launches_by_path["ppo"]
    for name, source, replaces, key, err, num in (
            ("decode_chunk_tc (K4)", "decode_chain_tc.cuh",
             "transformer_gan_tpu/ops/pallas_decode.py:359", "decode_chunk_tc",
             "K4", "span_K4"),
            ("decode_step_tc (K5)", "decode_chain_tc.cuh",
             "transformer_gan_tpu/ops/pallas_decode.py:82", "decode_step_tc",
             "K5", "span_K5"),
            ("chain_bwd_res_tc (K6)", "chain_bwd_tc.cu",
             "transformer_gan_tpu/ops/pallas_chain_bwd.py:301",
             "chain_bwd_res_tc", "K6", "span_K6"),
            ("chain_bwd_recompute_tc (K7)", "chain_bwd_tc.cu",
             "transformer_gan_tpu/ops/pallas_chain_bwd.py:103",
             "chain_bwd_recompute_tc", "K7", "span_K7"),
            ("xl_attn_fwd_v2_tc (K1f)", "attention_v2_tc.cu",
             "transformer_gan_tpu/ops/pallas_attention_v2.py:111",
             "xl_attn_fwd_v2_tc", "fwd_v2", "span_v2"),
            ("xl_attn_bwd_v2_tc (K1b)", "attention_v2_tc_bwd.cu",
             "transformer_gan_tpu/ops/pallas_attention_v2.py:166",
             "xl_attn_bwd_v2_tc", "v2", "span_bwd_v2")):
        kernels.append(entry(f"{name} at the spanbert op-point", source,
                             replaces, key, *worst([span_errs[err]]),
                             numbers[num], path="gan_bert"))
    # the metrics' generation: K3's gumbel route at B 32, M 2048
    kernels.append(entry(
        "generate_chunk_tc (K3, gumbel-argmax at the metrics op-point)",
        "decode_chain_tc.cuh", "transformer_gan_tpu/ops/pallas_generate.py:105",
        "generate_chunk_tc", gumbel_errs["float32"], gumbel_errs["bfloat16"],
        numbers["gen_gumbel"], path="metrics"))
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
    for k in ("xl_attn_fwd_v2", "xl_attn_fwd_v2_tc", "generate_chunk",
              "generate_chunk_tc"):
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
    """Kernel and plain times at M 4146 in bf16 (CUDA events): the decode
    chain's K3 (first one traced K3 and K4 call, the process's first
    traces), then the attention forwards."""
    from transformer_gan_torch import profile_generate as pg
    from transformer_gan_torch.ops import generate as gen_ops
    res = {}
    traces = {"K3": pg.profile_chunk("K3", 1, kc.MEM_LEN, top=6),
              "K4": pg.profile_chunk("K4", B_GAN, kc.GAN_MEM, top=6)}
    phase("numbers.decode_chain_trace", card=card, **traces)
    res["traces"] = traces
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
        bound, by = kc.bound_ms(*kc.sampler_work(32, B, kc.MEM_LEN,
                                                 kc.MEM_LEN))
        # worked out, not measured: the phase line carries them, the
        # kernels line only what this run measured (and the bound)
        group, splits = gen_ops.chain_route(10, B, kc.MEM_LEN + 32, "cuda:0")
        line.update(bound_ms=bound, bound_by=by,
                    stream_floor_ms=kc.sampler_stream_bytes(
                        32, B, kc.MEM_LEN, kc.MEM_LEN) / kc.PEAK_BYTES * 1e3,
                    key_splits=splits, lane_group=group,
                    launches_per_token_by_design=kc.chain_launches_per_token(
                        6, splits, group),
                    ms_by_route=kc.time_decode_routes(B))
        phase("numbers.generate", **line)
        num = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": by,
               "shape": f"32 tokens, B {B}, M {kc.MEM_LEN}, bf16"}
        if B == 1:
            num.update(library_ms=None, library_call="none computes top-k "
                       "sampling through the decoder")
            res["gen"] = dict(num)
            res["gen_tc"] = dict(
                num,
                launches_per_token_traced=traces["K3"]["launches_per_token"],
                busy_share_traced=traces["K3"]["busy_share"],
                busy_share_call_traced=traces["K3"]["busy_share_call"])
        else:
            res["gen_tc"]["other_shapes"] = [num]
        del case
    # the fp32 chain, the on-card reference
    case = kc.GenerateCase("float32", 1, kc.MEM_LEN)
    g = case.noise(32)
    ms, plain_ms = kc.time_in_turns(
        lambda: case.run(32, g), lambda: case.run(32, g, plain=True), iters=2)
    ref = {"fp32_ms": ms, "fp32_plain_ms": plain_ms,
           "fp32_bound_ms": kc.bound_ms(*kc.sampler_work(
               32, 1, kc.MEM_LEN, kc.MEM_LEN, es=4), "float32")[0],
           "fp32_shape": f"32 tokens, B 1, M {kc.MEM_LEN}, fp32 (the "
           "reference chain of decode_chain.cuh)"}
    res["gen"].update(ref)
    phase("numbers.generate_fp32", card=card, **ref)
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
    as plain keys; nested groups merged key by key), written beside the
    corpus."""
    import yaml

    def merge(node, over):
        for k, v in over.items():
            if isinstance(v, dict):
                merge(node.setdefault(k, {}), v)
            else:
                node[k] = v

    with open(os.path.join(ROOT, "training_config", base)) as f:
        cfg = yaml.safe_load(f)
    for key, value in groups.items():
        if isinstance(value, dict):
            merge(cfg.setdefault(key, {}), value)
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
    if (len(summary["files"]) != 2 or launches["generate_chunk"] == 0
            or launches["generate_chunk_tc"] == 0):
        fail(f"generation from the trained run: {summary}, {launches}")
    for k in total:
        total[k] += launches[k]
    phase("main_path.train_generate", files=len(summary["files"]),
          tokens=summary["tokens"], launches=launches)
    return total, os.path.join(ROOT, runs["mem1024"]["run_dir"])


# ---------------------------------------------------------------------------
# The codec: MIDI -> tokens -> train -> generate -> MIDI
# ---------------------------------------------------------------------------

CODEC_SEED = 1234
CODEC_PIECES = {"train": 200, "valid": 24, "test": 24}
CODEC_GRID = {"stretch_factors": [0.95, 0.975, 1.0, 1.025, 1.05],
              "pitch_transpose_lower": -3, "pitch_transpose_upper": 3}
CODEC_EXACT_PIECES = 4      # train pieces held bit-exact over the whole grid
# the shipped schedule (lr 0.004, inv_sqrt, warmup 4000) cut at 500 steps:
# the lr ramps to 5e-4 (lr 1e-3 after 100 warm-up steps left the model on
# the unigram plateau; PERF.md)
CODEC_TRAIN = {"batch_size": B_TRAIN, "max_step": 500, "log_interval": 50,
               "eval_interval": 100}
CODEC_SAMPLING = ["--techniques", "topk,random", "--temperatures", "0.95",
                  "--threshold", "32"]
CODEC_PREFIX = 50


def _python_module(*args) -> tuple[float, str]:
    """Run ``python -m ...`` from the checkout; (seconds, its stdout)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"{args[0]} exited {out.returncode}: {out.stderr[-3000:]}")
    return time.perf_counter() - t0, out.stdout


def _codec_exact(midi: str, data: str) -> dict:
    """The npy files the CLI wrote on the native encoder against the port's
    pure-Python encoder: the first CODEC_EXACT_PIECES train pieces over the
    whole grid and every valid piece canonically, bit for bit; both
    encoders timed on the same pieces in this process."""
    import numpy as np
    from transformer_gan_torch.data.codec import PerformanceEventRepo

    train = [os.path.join(midi, "train", f"p{i:04d}.mid")
             for i in range(CODEC_EXACT_PIECES)]
    valid = [os.path.join(midi, "valid", f"p{i:04d}.mid")
             for i in range(CODEC_PIECES["valid"])]
    encoded, timing = {}, {}
    for encoder in ("python", "native"):
        grid = PerformanceEventRepo(encoder=encoder, **CODEC_GRID)
        canon = PerformanceEventRepo(encoder=encoder)
        t0 = time.perf_counter()
        out = [list(grid.encode_transposition(p)) for p in train]
        out += [[canon.encode(p)] for p in valid]
        seconds = time.perf_counter() - t0
        encoded[encoder] = out
        tokens = sum(len(ids) for piece in out for ids in piece)
        encodings = sum(len(piece) for piece in out)
        timing[encoder] = {"seconds": seconds, "encodings": encodings,
                           "tokens": tokens,
                           "encodings_per_s": encodings / seconds,
                           "tokens_per_s": tokens / seconds}
    written = []
    for path in train:
        stem = os.path.splitext(os.path.basename(path))[0]
        written.append([np.load(os.path.join(data, "train",
                                             f"{stem}_arg{k}.npy")).tolist()
                        for k in range(35)])
    for path in valid:
        written.append([np.load(os.path.join(
            data, "valid", os.path.basename(path)[:-4] + ".npy")).tolist()])
    cases = sum(len(piece) for piece in written)
    if not (encoded["python"] == encoded["native"] == written):
        fail("the native encoder's npy files differ from the pure-Python "
             "encoder's")
    return {"cases_bit_exact": cases, "timing": timing}


def _corpus_stats(data: str) -> dict:
    """Pieces, tokens, ids used and the unigram entropy (nats) by split."""
    import glob
    import math
    import numpy as np
    stats = {}
    for split in ("train", "valid", "test"):
        files = sorted(glob.glob(os.path.join(data, split, "*.npy")))
        counts = np.zeros(310, np.int64)
        for f in files:
            counts += np.bincount(np.load(f), minlength=310)
        p = counts[counts > 0] / counts.sum()
        stats[split] = {"pieces": len(files), "tokens": int(counts.sum()),
                        "ids_used": int((counts > 0).sum()),
                        "unigram_entropy": float(-(p * np.log(p)).sum())}
    stats["log_vocab"] = math.log(310)
    return stats


def fixed_point_passes(repo, path: str, work: str, limit: int = 5):
    """decode -> encode from a MIDI file until the ids stop changing: the
    passes it took, or None past ``limit`` (the CPU tests use it too)."""
    prev = repo.encode(path)
    for it in range(1, limit + 1):
        mid = os.path.join(work, f"fixed_point_{it}.mid")
        repo.decode(prev, save_path=mid)
        cur = repo.encode(mid)
        if cur == prev:
            return it
        prev = cur
    return None


def run_codec_path(_native) -> dict:
    """The MIDI-to-MIDI pipeline through the port's entry points at the
    baseline model's full width: the synthetic corpus as MIDI
    (tools.make_synth_corpus, seed 1234, 200 / 24 / 24 pieces), cli.encode
    on the native encoder (the train split's 35-way grid, valid / test
    canonical) held bit-exact against the pure-Python encoder, cli.train
    on that directory (B 128, tgt 128, mem 1024, 500 steps of the shipped
    schedule; K1f, K1b), cli.batch_generate
    from the trained run (M 4146, 4096 tokens, a valid piece's first 50
    tokens and the unconditional run under topk 32 / T 0.95 and random; K1f,
    K3), and each MIDI file it writes re-encoded to a decode -> encode fixed
    point within 5 passes. Returns the launches of training and generation."""
    import math
    import shutil
    from transformer_gan_torch.cli import batch_generate as bcli
    from transformer_gan_torch.cli import train as tcli
    from transformer_gan_torch.data.codec import PerformanceEventRepo

    t_start = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke", "codec")
    shutil.rmtree(work, ignore_errors=True)
    midi, data = os.path.join(work, "midi"), os.path.join(work, "data")
    corpus_s, _ = _python_module(
        "transformer_gan_torch.tools.make_synth_corpus", "--out_dir", midi,
        "--write_midi", "--seed", str(CODEC_SEED),
        *(a for split, n in CODEC_PIECES.items()
          for a in (f"--n_{split}", str(n))))
    encode_s, printed = _python_module(
        "transformer_gan_torch.cli.encode", "--input_folder", midi,
        "--output_folder", data, "--mode", "midi_to_npy",
        "--encode_official_maestro")
    if "encoder: native (" not in printed:
        fail(f"cli.encode did not run the native encoder: {printed}")
    corpus = _corpus_stats(data)
    want = {"train": CODEC_PIECES["train"] * 35,
            "valid": CODEC_PIECES["valid"], "test": CODEC_PIECES["test"]}
    if {k: corpus[k]["pieces"] for k in want} != want:
        fail(f"cli.encode wrote {corpus}, expected {want} pieces")
    exact = _codec_exact(midi, data)

    cfg = _train_cfg_file(work, "codec.yml", **CODEC_TRAIN)
    torch.cuda.synchronize()
    _native.reset_launches()
    t0 = time.perf_counter()
    trainer = tcli.main(["--data_dir", data, "--cfg", cfg, "--work_dir",
                         os.path.join(work, "run")])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(_native.LAUNCHES)
    log = _train_log(trainer.work_dir)
    if not log["val_nll"] or not all(math.isfinite(x) for x in
                                     log["val_nll"] + [s["nll"] for s in
                                                       log["train"]]):
        fail(f"training on the MIDI-made corpus logged no finite NLL: {log}")

    prefix = os.path.join(data, "valid", "p0000.npy")
    common = ["--model_directory", trainer.work_dir, "--checkpoint_name",
              "checkpoint_last", "--output_base", os.path.join(work, "gen"),
              "--memory_length", "4146", "--generation_length",
              str(GEN_LENGTH), "--num_conditional_tokens", str(CODEC_PREFIX),
              "--device", "cuda:0", *CODEC_SAMPLING]
    torch.cuda.synchronize()
    _native.reset_launches()
    t0 = time.perf_counter()
    runs = bcli.main([*common, "--prefix", prefix]) + bcli.main(common)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    gen_launches = dict(_native.LAUNCHES)

    launches = {k: train_launches[k] + gen_launches[k] for k in gen_launches}
    for name, counts, keys in (
            ("cli.train", train_launches,
             ("xl_attn_fwd_v2", "xl_attn_bwd_v2", "xl_attn_fwd_v2_tc",
              "xl_attn_bwd_v2_tc")),
            ("cli.batch_generate", gen_launches,
             ("xl_attn_fwd_v2", "xl_attn_fwd_v2_tc", "generate_chunk",
              "generate_chunk_tc"))):
        for k in keys:
            if counts[k] == 0:
                fail(f"{name} on the MIDI-made corpus never launched {k}")

    repo = PerformanceEventRepo()
    vocab = set(repo.events_to_ids)
    generated, passes = [], []
    for r in runs:
        primed = r["tag"].startswith("p0000")
        for fp in r["summary"]["files"]:
            with open(fp) as f:
                toks = [l.strip() for l in f if l.strip()]
            want_len = GEN_LENGTH + (CODEC_PREFIX if primed else 0)
            if len(toks) != want_len or not set(toks) <= vocab:
                fail(f"{fp}: {len(toks)} tokens (expected {want_len}) or a "
                     "token outside the vocab")
        if len(r["midi"]) != len(r["summary"]["files"]):
            fail(f"batch_generate wrote {r['midi']} for "
                 f"{r['summary']['files']}")
        for m in r["midi"]:
            n = fixed_point_passes(repo, m, work)
            if n is None:
                fail(f"{m}: decode -> encode reached no fixed point in 5 "
                     "passes")
            passes.append(n)
        generated.append({
            "tag": r["tag"], "files": len(r["summary"]["files"]),
            "tokens": r["summary"]["tokens"],
            "generate_s": r["summary"]["generate_seconds"],
            "tokens_per_s": r["summary"]["tokens"]
            / r["summary"]["generate_seconds"]})
    if len(passes) != 4:
        fail(f"batch_generate wrote {len(passes)} MIDI files, expected 4")

    steady = [s["tokens_per_s"] for s in log["train"][1:]]
    entropy = corpus["train"]["unigram_entropy"]
    res = {"seconds": time.perf_counter() - t_start, "seed": CODEC_SEED,
           "corpus": corpus, "corpus_write_s": corpus_s,
           "encode_cli_s": encode_s, "encode_cli_pieces":
           sum(CODEC_PIECES.values()), "encode_cli_files": sum(want.values()),
           "encode_cli_tokens": sum(corpus[k]["tokens"] for k in want),
           **exact, "train_overrides": CODEC_TRAIN, "train_s": train_s,
           "train_steps": trainer.train_step_num,
           "train_tokens_per_s_logged": [s["tokens_per_s"]
                                         for s in log["train"]],
           "train_tokens_per_s_steady": sum(steady) / max(1, len(steady)),
           "train_nll_logged": [s["nll"] for s in log["train"]],
           "val_nll": log["val_nll"], "test_nll": log["test_nll"],
           "train_unigram_entropy": entropy,
           "log_vocab": corpus["log_vocab"],
           "val_nll_below_unigram_entropy": log["val_nll"][-1] < entropy,
           "generate_s": generate_s, "generated": generated,
           "midi_files": len(passes), "fixed_point_passes": passes,
           "launches": {"train": train_launches, "generate": gen_launches}}
    phase("main_path.codec", **res)
    return launches


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


def check_train_reference(status: bool = False, cache_kv: bool = True,
                          steps: int = 2) -> dict:
    """``steps`` MLE steps at full width in fp32 (B 2, tgt 128, mem 256,
    dropout 0, a reset row in step 2): the card's path (the kernels; plain
    torch under raw-hidden memory, ``cache_kv`` False) against the plain
    path on the CPU, same batches and weights; ``status``: with seeded
    note-status vectors. Per step: the loss, the pre-clip grad norm and
    every gradient leaf; after the steps the parameters and the new
    memories (atol 1e-3: six layers, the kernel check's K/V bound).
    Tolerances: ``TRAIN_REF_TOL``; the grad norm's rtol allows for fp32 sums
    in another order over 13.7M gradients. An FF unit the two devices put
    on two sides of its ReLU's kink for some token gives each another valid
    gradient (an H100 read 1.2e-2 of layers.5.ff_w1's largest entry from
    one with note-status inputs): the CPU takes the card's ReLU decision
    where its own pre-activation lies within ``GAN_REF_TOL["kink_band"]``
    of its row's largest, the GAN checks' rule (``kernel_check._FFPre`` on
    ``xl.xl_forward``); a sign that differs outside the band fails, and so
    do more than ``GAN_REF_TOL["kink_units"]`` units replayed."""
    from transformer_gan_torch import kernel_check as kc

    B, tgt, M = 2, 128, 256
    gen = torch.Generator().manual_seed(3)
    batches = [(torch.randint(2, 310, (1, tgt, B), generator=gen),
                torch.randint(2, 310, (1, tgt, B), generator=gen),
                torch.tensor([[False, i == 1]]),
                torch.rand((1, tgt, B, kc.STATUS_SLOTS), generator=gen) < 0.1
                if status else None) for i in range(steps)]
    out, pre = {}, {}
    band = kc.GAN_REF_TOL["kink_band"]
    for device in ("cuda:0", "cpu"):
        case = kc.TrainCase(B=B, tgt=tgt, M=M, dtype="float32", dropout=0.0,
                            device=device, status=status, cache_kv=cache_kv)
        mets, grads = [], []
        with kc._FFPre(replay=pre.get("cuda:0"), band=band,
                       passes=("xl_forward",)) as ff:
            for d, t, r, sv in batches:
                d, t, r = d.to(device), t.to(device), r.to(device)
                sv = None if sv is None else sv.to(device)
                grads.append(case.flat_grad(d, t, r, sv).cpu())
                case.state, met = case.fn(case.state, d, t, r, sv)
                mets.append({k: float(v) for k, v in met.items()})
        pre[device] = ff.pre
        out[device] = (mets, grads, case.state.flat.detach().cpu(),
                       case.state.mems[0].hids.cpu())
    kinks = kc.kink_stats(pre["cuda:0"], pre["cpu"], band)
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
            "status": status, "cache_kv": cache_kv, "steps": steps,
            **kinks,
            "ok": (loss_rel <= tol["loss_rel"]
                   and gn_rel <= tol["grad_norm_rel"]
                   and gn_self <= tol["grad_norm_rel"]
                   and leaf_rel <= tol["grad_leaf_rel"]
                   and p_excess <= tol["param_atol"]
                   and m_err <= tol["mem_abs"]
                   and kinks["kink_outside"] == 0
                   and len(kinks["kink_units"])
                   <= kc.GAN_REF_TOL["kink_units"])}


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


def check_generate_grouped(kc) -> dict:
    """K3's bf16 chain on the lane-grouped decode attention at the metrics
    eval's wave (gumbel-argmax, same_length off, B 32, M 2048): counts 0,
    256, 1024 and 2016, a 32-token chunk then a 7-token one, against the
    plain version with the route's splits and the unsplit one (the first
    step's logits within LOGIT_ULPS_BF16), each call counted once in
    generate_chunk_grouped; then K4 and K5 at the GAN's shapes (B 64 at
    M 64, B 32 at M 128, B 8 at M 128), which keep split_attn_kernel (no
    decode_chunk_grouped or decode_step_grouped count), and at B 8, M 1024,
    where they take lane groups (check_decode holds each launch's count
    against the route)."""
    from transformer_gan_torch import _native
    t0 = time.perf_counter()
    errs, cases = 0.0, []
    for count in (0, 256, 1024, METRICS_SEQ - 32):
        res = kc.check_generate("bfloat16", 32, count, chunks=(32, 7),
                                M=METRICS_SEQ, technique="gumbel",
                                same_length=False)
        cases.append({k: res[k] for k in ("count", "ok", "max_abs_err")}
                     | {"chunks": [{k: c[k] for k in (
                         "n", "splits", "lane_group", "grouped_calls",
                         "logit0_ulps", "logit0_ulps_vs_unsplit",
                         "ids_equal")} for c in res["chunks"]]})
        if not res["ok"]:
            fail(f"K3 disagrees on the lane-grouped route: {res}")
        errs = max(errs, res["max_abs_err"])
    names = ("decode_chunk_grouped", "decode_step_grouped")
    gan = []
    for B, M in ((B_GAN, kc.GAN_MEM), (32, 128), (8, 128), (8, 1024)):
        counts0 = [_native.LAUNCHES[k] for k in names]
        for step in (False, True):
            res = kc.check_decode("bfloat16", B, M, M=M, step=step,
                                  chunks=(32,))
            if not res["ok"]:
                fail(f"GAN sampler kernel disagrees: {res}")
        grouped = [_native.LAUNCHES[k] - c for k, c in zip(names, counts0)]
        gan.append({"B": B, "M": M, "lane_group": res["chunks"][0][
            "lane_group"], "grouped_calls": dict(zip(names, grouped))})
        if (B, M) != (8, 1024) and any(grouped):
            fail(f"K4 / K5 took lane groups at the GAN's shape: {gan[-1]}")
    torch.cuda.empty_cache()
    phase("kernels.generate_grouped", B=32, M=METRICS_SEQ, technique="gumbel",
          same_length=False, cases=cases, max_abs_err=errs, gan=gan,
          seconds=round(time.perf_counter() - t0, 1))
    return errs


def check_chain(kc) -> dict:
    """K6 and K7 against the plain chain at full width: n 59, M 64, fp32
    and bf16, B 8 and 64, count 0 and 64, T 1.0 and 0.5; and bf16 pre-norm
    at B 64, an odd count, T 0.7."""
    errs = {"K6": {}, "K7": {}}
    cases = [(dtype, B, count, T, False) for dtype in ("float32", "bfloat16")
             for B in (8, 64) for count in (0, kc.GAN_MEM) for T in (1.0, 0.5)]
    for dtype, B, count, T, pre in cases + [("bfloat16", 64, 37, 0.7, True)]:
        res = kc.check_chain(dtype, B, count, T, pre_lnorm=pre)
        phase("kernels.chain_bwd", **res)
        if not res["ok"]:
            fail(f"chain backward kernel disagrees: {res}")
        for key in ("K6", "K7"):
            errs[key][dtype] = max(errs[key].get(dtype, 0.0), res[key])
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


GAN_RUNS = (
    ("chunk_res", {}, None, ("decode_chunk", "decode_chunk_tc",
                             "chain_bwd_res", "chain_bwd_res_tc",
                             "xl_attn_fwd_v2", "xl_attn_bwd_v2",
                             "xl_attn_fwd_v2_tc", "xl_attn_bwd_v2_tc")),
    ("step_recompute", {"gan_chain_bwd": "kernel_recompute"}, "0",
     ("decode_step", "decode_step_tc", "chain_bwd_recompute",
      "chain_bwd_recompute_tc")))


def _gan_cli_runs(_native, label: str, base: str, overrides: dict,
                  disc: dict, warm: str, check=None,
                  runs=GAN_RUNS) -> tuple[dict, dict]:
    """The training CLI on config ``base`` with ``overrides`` (TRAIN),
    ``disc`` (DISCRIMINATOR) and the warm start ``warm``, once for each of
    ``runs`` (GAN_RUNS: the chunk sampler and the reverse chain on the
    residuals (K4, K6), then --restart for one more step; the per-token
    sampler and the recomputing chain (K5, K7)). Each run must launch its kernels, log gen and dis
    losses and checkpoint the GAN state; ``check(trainer, name)`` adds a
    run's own checks and returns what it read. Returns (launch counts
    summed over the runs, the runs' records)."""
    from transformer_gan_torch.cli import train as tcli
    from transformer_gan_torch.train import checkpoint as ckpt
    work = os.path.join(ROOT, "build", "chip_smoke", label)
    os.makedirs(work, exist_ok=True)
    data = os.path.join(ROOT, "build", "chip_smoke", "train", "data")
    total = dict.fromkeys(_native.LAUNCHES, 0)
    records = {}
    for name, tpu, env, need in runs:
        cfg = _train_cfg_file(work, f"{name}.yml", base, **overrides,
                              load_from_previous=warm, DISCRIMINATOR=disc,
                              TPU=tpu)
        if env is not None:
            os.environ["TGTPU_CHUNK_SAMPLER"] = env
        torch.cuda.synchronize()
        _native.reset_launches()
        t0 = time.perf_counter()
        try:
            tr = tcli.main(["--data_dir", data, "--cfg", cfg, "--work_dir",
                            os.path.join(work, name)])
            torch.cuda.synchronize()
            launches = dict(_native.LAUNCHES)
            checked = check(tr, name) if check else None
            restart = None
            if name == "chunk_res":
                counts = (tr.gan.dis_opt_state.count,
                          tr.gan.gen_opt_state.count)
                cfg4 = _train_cfg_file(work, f"{name}_4.yml", base,
                                       **{**overrides, "max_step": 4},
                                       load_from_previous=warm,
                                       DISCRIMINATOR=disc, TPU=tpu)
                _native.reset_launches()
                again = tcli.main(["--data_dir", data, "--cfg", cfg4,
                                   "--work_dir", tr.work_dir, "--restart"])
                torch.cuda.synchronize()
                restart = {"steps": again.train_step_num,
                           "dis_updates": [counts[0],
                                           again.gan.dis_opt_state.count],
                           "gen_updates": [counts[1],
                                           again.gan.gen_opt_state.count],
                           "checked": (check(again, name + " restart")
                                       if check else None)}
                if (again.gan.gen_opt_state.count != counts[1] + 1
                        or again.gan.dis_opt_state.count
                        != counts[0] + tr.cfg.DISCRIMINATOR.dis_steps):
                    fail(f"--restart lost the {label} GAN state: {restart}")
                launches = {k: launches[k] + _native.LAUNCHES[k]
                            for k in launches}
        finally:
            os.environ.pop("TGTPU_CHUNK_SAMPLER", None)
        wall = time.perf_counter() - t0
        for k in need:
            if launches[k] == 0:
                fail(f"the {label} run {name} never launched {k}")
        log = _gan_log(tr.work_dir)
        if (len(log) < 3 or not all(abs(x["gen_loss"]) > 0 and abs(x["dis_loss"])
                                    > 0 for x in log[1:])):
            fail(f"the {label} run {name} logged no gen / dis losses: {log}")
        if ckpt.load_gan_payload(tr.work_dir, "checkpoint_last") is None:
            fail(f"the {label} run {name} checkpointed no GAN state")
        records[name] = {"run_dir": os.path.relpath(tr.work_dir, ROOT),
                         "steps": tr.train_step_num, "wall_s": wall,
                         "launches": launches, "log": log,
                         "dis_updates": tr.gan.dis_opt_state.count,
                         "gen_updates": tr.gan.gen_opt_state.count,
                         "checked": checked, "restart": restart}
        for k in total:
            total[k] += launches[k]
    return total, records


def run_gan_path(_native, mle_run: str) -> dict:
    """The training CLI on experiment_cnn.yml (batch 64, warm start from the
    MLE run, dis and gen phases at steps 1 and 2), then --restart for a
    third (K4, K6); a second run on the per-token sampler and the
    recomputing chain (K5, K7). Returns the launch counts of the runs."""
    warm = os.path.join(mle_run, "checkpoint_last")
    disc = {"dis_loss_freq": 1, "gen_loss_freq": 1}
    total, runs = _gan_cli_runs(_native, "gan", "experiment_cnn.yml",
                                GAN_OVERRIDES, disc, warm)
    phase("main_path.gan", overrides=GAN_OVERRIDES, discriminator=disc,
          warm_start=os.path.relpath(warm, ROOT), **runs)
    return total


def _time_gan_phases(cases: dict, lanes: int) -> dict:
    """The dis phase, the gen phase and one sampling pass (a micro-batch of
    ``lanes``) of the plain and the kernel route's ``kernel_check.GanCase``,
    after a warm-up, in turns (plain, kernel, kernel, plain); ms and the
    sampled tokens/s."""
    from transformer_gan_torch.models import gan as gan_mod

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
        noise = [draws.gumbel(c, n, lanes, 310)
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
    toks = lanes * sum(cases["kernel"].phases.gcfg.chunk_lengths())
    timed["sample"].update(
        tokens=toks,
        kernel_tokens_per_s=toks / (timed["sample"]["kernel_ms"] / 1e3),
        plain_tokens_per_s=toks / (timed["sample"]["plain_ms"] / 1e3))
    return timed


def measure_gan(kc, card: str) -> dict:
    """bf16 at the GAN op-point (B 64, M 64, 59 sampled tokens): the dis
    phase (5 updates) and the gen phase in ms, and sampled tokens/s, of the
    kernel path against the plain path (the sampler and chain plain
    versions on the card) in turns; then each of K4, K5, K6 and K7 per
    launch against its plain version, beside its bound, in bf16 and fp32,
    and one K6 and one K7 call traced (profile_chain)."""
    res = {}
    cases = {r: kc.GanCase("bfloat16", B_GAN, "cuda", route=r, dis_steps=5,
                           host_draws=False)
             for r in ("plain", "kernel")}
    timed = _time_gan_phases(cases, B_GAN)
    phase("numbers.gan", B=B_GAN, M=kc.GAN_MEM, dtype="bfloat16", card=card,
          dis_phase=timed["dis"], gen_phase=timed["gen"],
          sampling=timed["sample"])
    del cases
    torch.cuda.empty_cache()

    no_lib = "none computes the gumbel sampler through the decoder"
    # K4 and K5 on the bf16 chain (the entries of both names) and on the
    # fp32 reference chain (the "fp32_" keys of the plain names)
    for dtype, es in (("bfloat16", 2), ("float32", 4)):
        case = kc.DecodeCase(dtype, B_GAN, kc.GAN_MEM)
        g = case.noise(32)
        ms, plain_ms = kc.time_in_turns(lambda: case.run(32, g),
                                        lambda: case.run(32, g, plain=True), 5)
        bound, by = kc.bound_ms(*kc.sampler_work(32, B_GAN, kc.GAN_MEM,
                                                 kc.GAN_MEM, es=es), dtype)
        k4 = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
              "bound_by": by, "library_ms": None, "library_call": no_lib,
              "shape": f"32 tokens, B {B_GAN}, M {kc.GAN_MEM}, {dtype}"}
        L, _, H, B, _, dh = case.kv.shape
        staged = torch.zeros((L, 2, H, B, 32, dh), dtype=case.kv.dtype,
                             device=case.kv.device)

        def step(plain):
            fn = (case.ops.fused_decode_step_plain if plain
                  else case.ops.fused_decode_step)
            return fn(case.stacked, case.cfg, case.kv, case.R, staged,
                      case.ids, g[5], 5, case.count)

        ms, plain_ms = kc.time_in_turns(lambda: step(False),
                                        lambda: step(True), 20)
        bound, by = kc.bound_ms(*kc.sampler_work(1, B_GAN, kc.GAN_MEM,
                                                 kc.GAN_MEM, es=es, t0=5), dtype)
        k5 = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
              "bound_by": by, "library_ms": None, "library_call": no_lib,
              "shape": f"1 token at step 5, B {B_GAN}, M {kc.GAN_MEM}, {dtype}"}
        for key, num in (("K4", k4), ("K5", k5)):
            if dtype == "bfloat16":
                res[key], res[key + "_tc"] = dict(num), dict(num)
            else:
                res[key].update({"fp32_" + k: num[k]
                                 for k in ("ms", "plain_ms", "bound_ms",
                                           "shape")})
        del case, staged
    # K6 and K7 on the bf16 reverse chain (the entries of both names) and
    # on the fp32 chain, the on-card reference (the "fp32_" keys)
    from transformer_gan_torch import profile_chain
    for dtype, es in (("bfloat16", 2), ("float32", 4)):
        chain = kc.ChainCase(dtype, B_GAN, kc.GAN_MEM)
        for key, variant, recompute in (("K6", "res", False),
                                        ("K7", "recompute", True)):
            ms, plain_ms = kc.time_in_turns(lambda: chain.run(variant),
                                            lambda: chain.run("plain"), 2)
            bound, by = kc.bound_ms(*kc.chain_work(
                chain.n, B_GAN, kc.GAN_MEM, kc.GAN_MEM, recompute, es=es),
                dtype)
            shape = (f"n {chain.n}, B {B_GAN}, M {kc.GAN_MEM}, count "
                     f"{kc.GAN_MEM}, {dtype}")
            if dtype == "float32":
                res[key].update(fp32_ms=ms, fp32_plain_ms=plain_ms,
                                fp32_bound_ms=bound, fp32_shape=shape)
                continue
            trace = profile_chain.profile_call(variant, chain)
            res[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "library_ms": None,
                        "library_call": "none computes the straight-through "
                        "chain's backward", "shape": shape,
                        "launches_per_token_traced":
                            trace["launches_per_token"],
                        "busy_share_traced": trace["busy_share"],
                        "busy_share_call_traced": trace["busy_share_call"]}
        del chain
        torch.cuda.empty_cache()
    for key in ("K6", "K7"):
        res[key + "_tc"] = {k: v for k, v in res[key].items()
                            if not k.startswith("fp32_")}
    phase("numbers.gan_kernels", card=card,
          **{k: res[k] for k in ("K4", "K5", "K6", "K7")})
    # worked out, not measured (so a phase line carries it, the kernels line
    # only what this run measured): K6's streaming floor, each token
    # rereading its K/V lanes (50 MB at count M, more than L2)
    phase("numbers.reverse_chain_floor", stream_floor_ms=kc.chain_stream_bytes(
        59, B_GAN, kc.GAN_MEM, kc.GAN_MEM) / kc.PEAK_BYTES * 1e3)
    return res


# ---------------------------------------------------------------------------
# The spanbert op-point: BERT pretraining and the BERT critic under wgan-gp
# ---------------------------------------------------------------------------

# experiment_spanbert.yml at one card's batch (128 of the reference's 512
# over 4 GPUs): DISCRIMINATOR.batch_chunk 4 gives 32 GAN lanes; tgt_len 128
# over sample_chunks_mem 2 gives chunks of 64 tokens, the first 59 after the
# 5-token context: K4 calls of 32 + 27 and 32 + 32, K6 at n 59 and 64, all
# at mem_len 128. TRAIN.batch_chunk 4: the MLE step's K1f / K1b at q 128,
# B 32, M 1024.
B_SPAN, SPAN_MEM = 32, 128
SPAN_OVERRIDES = {"batch_size": 128, "max_step": 3, "log_interval": 1,
                  "eval_interval": 3}
# cli.bert_pretrain's defaults (block 512, 16 rows, lr 5e-5, 15% masking)
# in bf16: tens of steps, an eval at 15 and 30, saves at 10 / 20 / 30 with
# save_total_limit 2 (checkpoint-10 rotated out)
BERT_STEPS = 30
BERT_ARGS = ["--max_steps", str(BERT_STEPS), "--logging_steps", "5",
             "--save_steps", "10", "--eval_steps", "15", "--save_total_limit",
             "2", "--compute_dtype", "bfloat16"]


def spanbert_case(bert_ckpt: str) -> dict:
    """kernel_check.GanCase's arguments for the spanbert config with the
    smoke's MLM checkpoint as the critic."""
    return {"config": "experiment_spanbert.yml",
            "overrides": {"DISCRIMINATOR": {"BERT": {"model_path": bert_ckpt}}}}


def check_spanbert_shapes(kc) -> dict:
    """The GAN kernels at the spanbert op-point's shapes against their plain
    versions, fp32 and bf16 with the existing tolerances: K4 over the four
    calls of a micro-batch (32 and 27 tokens of chunk 0, then 32 and 32 of
    chunk 1 on the ring K4 left, counts from 0 and from the prime's 4) and
    K5 the same way; K6 and K7 at n 59 (count 4, chunk 0) and n 64 (counts
    63 and 128); K1f / K1b at the MLE step's q 128, B 32, M 1024."""
    errs = {k: {} for k in ("K4", "K5", "K6", "K7", "v2", "fwd_v2")}
    cases = []
    for dtype in ("float32", "bfloat16"):
        for count, step in ((0, False), (4, False), (4, True)):
            res = kc.check_decode(dtype, B_SPAN, count, chunks=(32, 27, 32, 32),
                                  step=step, M=SPAN_MEM)
            cases.append({k: res[k] for k in ("kernel", "dtype", "B", "count",
                                              "ok", "max_abs_err")}
                         | {"calls": [{k: c[k] for k in c
                                       if k != "first_divergence"}
                                      for c in res["chunks"]]})
            if not res["ok"]:
                fail(f"GAN sampler kernel disagrees at B {B_SPAN}, M "
                     f"{SPAN_MEM}: {res}")
            errs[res["kernel"]][dtype] = max(errs[res["kernel"]].get(dtype, 0.0),
                                             res["max_abs_err"])
        for n, count in ((59, 4), (64, 63), (64, SPAN_MEM)):
            res = kc.check_chain(dtype, B_SPAN, count, 1.0, n=n, M=SPAN_MEM)
            cases.append(res)
            if not res["ok"]:
                fail(f"chain backward kernel disagrees at B {B_SPAN}, M "
                     f"{SPAN_MEM}, n {n}: {res}")
            for key in ("K6", "K7"):
                errs[key][dtype] = max(errs[key].get(dtype, 0.0), res[key])
            torch.cuda.empty_cache()
        res = kc.check_attention_bwd("v2", getattr(torch, dtype), 128, B_SPAN,
                                     TRAIN_MEM, TRAIN_MEM, rate=0.1)
        cases.append({k: res[k] for k in ("variant", "dtype", "q", "B", "M",
                                          "max_abs_err", "ok")})
        if not res["ok"]:
            fail(f"K1f / K1b disagree at q 128, B {B_SPAN}, M {TRAIN_MEM}: "
                 f"{res}")
        errs["v2"][dtype] = max(v["max_abs_err"] for v in res["grads"].values())
        errs["fwd_v2"][dtype] = res["o_max_abs_err"]
        del res
        torch.cuda.empty_cache()
    phase("kernels.spanbert_shapes", B=B_SPAN, M=SPAN_MEM, cases=cases,
          max_abs_err=errs)
    return errs


def run_bert_pretrain(_native) -> str:
    """``transformer_gan_torch.cli.bert_pretrain`` at full width (5 layers,
    hidden 768) in bf16 on a seeded random corpus: BERT_STEPS steps, two
    evals, three saves and the rotation. Returns the last checkpoint."""
    import math
    from transformer_gan_torch.cli import bert_pretrain
    from transformer_gan_torch.config import PACKAGED_VOCAB
    from transformer_gan_torch.train import checkpoint as ckpt
    work = os.path.join(ROOT, "build", "chip_smoke", "bert")
    data, out = os.path.join(work, "data"), os.path.join(work, "out")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=64, train_len=2048,
                        n_eval=34, eval_len=500, seed=2)
    torch.cuda.synchronize()
    _native.reset_launches()
    t0 = time.perf_counter()
    tr = bert_pretrain.main(["--train_data_file", data, "--output_dir", out,
                             "--vocab_file", PACKAGED_VOCAB] + BERT_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [h["loss"] for h in tr.history if "loss" in h]
    evals = [h["eval_loss"] for h in tr.history if "eval_loss" in h]
    kept = sorted(os.listdir(out))
    path = os.path.join(out, f"checkpoint-{BERT_STEPS}")
    meta = ckpt.load_bert_metadata(path)
    params = ckpt.load_bert_params(path)
    res = {"steps": tr.step, "wall_s": wall, "losses": losses,
           "eval_losses": evals, "checkpoints": kept, "metadata": meta,
           "params": sum(v.numel() for v in params.values()),
           "train_blocks": len(tr.train_blocks),
           "valid_blocks": len(tr.valid_blocks), "args": BERT_ARGS}
    phase("main_path.bert_pretrain", **res)
    if (tr.step != BERT_STEPS or len(losses) != BERT_STEPS // 5
            or len(evals) != 2
            or not all(math.isfinite(x) for x in losses + evals)):
        fail(f"BERT pretraining logged no finite losses: {res}")
    if (kept != [f"checkpoint-{BERT_STEPS - 10}", f"checkpoint-{BERT_STEPS}"]
            or meta != {"step": BERT_STEPS, "config": {
                "vocab_size": 311, "num_hidden_layers": 5,
                "hidden_size": 768}}
            or not all(torch.equal(v, tr.params()[k].cpu())
                       for k, v in params.items())):
        fail(f"BERT pretraining wrote no rotated checkpoint: {res}")
    return path


def run_gan_bert_path(_native, mle_run: str, bert_ckpt: str) -> dict:
    """The training CLI on experiment_spanbert.yml at the op-point (batch
    128, warm start from the MLE run, the critic from the MLM checkpoint,
    GAN phases from step 1), 3 steps and --restart for a 4th (K4, K6, K1f /
    K1b); then the per-token sampler and the recomputing chain (K5, K7).
    Each run: the critic's trunk equal to the checkpoint's bitwise after
    the updates, its pooler and classifier weights moved. Returns the
    launch counts of the runs."""
    from transformer_gan_torch.models import bert as bert_mod
    from transformer_gan_torch.train import checkpoint as ckpt
    warm = os.path.join(mle_run, "checkpoint_last")
    disc = {"start_iter": 0, "dis_loss_freq": 1, "gen_loss_freq": 1,
            "BERT": {"model_path": bert_ckpt}}
    mlm = ckpt.load_bert_params(bert_ckpt)

    def critic(tr, name):
        live = {k: v.detach().cpu() for k, v in tr.gan.dis_params().items()}
        trunk = bert_mod.trunk_names(live)
        fresh = bert_mod.init_bert_params(tr.gan.dis_cfg, seed=17)
        same = all(torch.equal(live[k], mlm[k]) for k in trunk)
        moved = [k for k in ("pooler_w", "pooler_b", "classifier_w")
                 if not torch.equal(live[k], fresh[k])]
        if not same or len(moved) != 3 or len(tr.gan.dis_frozen) != len(trunk):
            fail(f"the spanbert run {name} moved the frozen critic trunk "
                 f"({not same}) or not its head ({moved})")
        return {"trunk_leaves_bitwise_equal": len(trunk), "head_moved": moved}

    total, runs = _gan_cli_runs(_native, "gan_bert", "experiment_spanbert.yml",
                                SPAN_OVERRIDES, disc, warm, check=critic)
    phase("main_path.gan_bert", overrides=SPAN_OVERRIDES, discriminator=disc,
          warm_start=os.path.relpath(warm, ROOT), **runs)
    return total


def measure_gan_bert(kc, card: str, bert_ckpt: str) -> dict:
    """bf16 at the spanbert op-point (B 128 in 4 micro-batches of 32, M 128,
    the MLM checkpoint as the critic): the dis phase (1 update) and the gen
    phase in ms and the sampling pass's tokens/s, kernel path against plain
    path in turns; one gen update by part (profile_chain.gen_update); then
    K4, K5, K6, K7, K1f and K1b at the op-point's shapes against their plain
    versions, beside their bounds. Returns the kernels line's numbers."""
    from transformer_gan_torch import profile_chain
    res = {}
    cases = {r: kc.GanCase("bfloat16", 128, "cuda", route=r, host_draws=False,
                           **spanbert_case(bert_ckpt))
             for r in ("plain", "kernel")}
    timed = _time_gan_phases(cases, B_SPAN)
    phase("numbers.gan_bert", B=128, lanes=B_SPAN, M=SPAN_MEM,
          dtype="bfloat16", card=card, dis_phase=timed["dis"],
          gen_phase=timed["gen"], sampling=timed["sample"])
    del cases["plain"]
    parts = profile_chain.gen_update(cases["kernel"])
    phase("numbers.gan_bert_gen_update", card=card, **parts)
    del cases
    torch.cuda.empty_cache()

    no_lib = "none computes the gumbel sampler through the decoder"
    dec = kc.DecodeCase("bfloat16", B_SPAN, 4, M=SPAN_MEM)
    g = dec.noise(32)
    ms, plain_ms = kc.time_in_turns(lambda: dec.run(32, g),
                                    lambda: dec.run(32, g, plain=True), 5)
    bound, by = kc.bound_ms(*kc.sampler_work(32, B_SPAN, SPAN_MEM, 4))
    res["span_K4"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": None,
                      "library_call": no_lib,
                      "shape": f"32 tokens, B {B_SPAN}, M {SPAN_MEM}, count 4"
                               ", bf16"}
    L, _, H, B, _, dh = dec.kv.shape
    staged = torch.zeros((L, 2, H, B, 32, dh), dtype=dec.kv.dtype,
                         device=dec.kv.device)

    def step(plain):
        fn = (dec.ops.fused_decode_step_plain if plain
              else dec.ops.fused_decode_step)
        return fn(dec.stacked, dec.cfg, dec.kv, dec.R, staged, dec.ids, g[5],
                  5, dec.count)

    ms, plain_ms = kc.time_in_turns(lambda: step(False), lambda: step(True),
                                    20)
    bound, by = kc.bound_ms(*kc.sampler_work(1, B_SPAN, SPAN_MEM, 4, t0=5))
    res["span_K5"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": None,
                      "library_call": no_lib,
                      "shape": f"1 token at step 5, B {B_SPAN}, M {SPAN_MEM}, "
                               "count 4, bf16"}
    del dec, staged
    chain = kc.ChainCase("bfloat16", B_SPAN, 63, n=64, M=SPAN_MEM)
    for key, variant, recompute in (("span_K6", "res", False),
                                    ("span_K7", "recompute", True)):
        ms, plain_ms = kc.time_in_turns(lambda: chain.run(variant),
                                        lambda: chain.run("plain"), 2)
        bound, by = kc.bound_ms(*kc.chain_work(64, B_SPAN, SPAN_MEM, 63,
                                               recompute))
        res[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": None,
                    "library_call": "none computes the straight-through "
                    "chain's backward",
                    "shape": f"n 64, B {B_SPAN}, M {SPAN_MEM}, count 63, bf16"}
    del chain
    torch.cuda.empty_cache()
    fwd, plain, bwd, bwd_p, fa, ba, kw = kc.attention_bwd_case(
        "v2", torch.bfloat16, 128, B_SPAN, TRAIN_MEM, TRAIN_MEM, rate=0.1)
    shape = f"q 128, B {B_SPAN}, M {TRAIN_MEM}, bf16, dropatt 0.1"
    none = "none: the position term comes from rk inside the kernel"
    ms, plain_ms = kc.time_in_turns(lambda: fwd(*fa, **kw),
                                    lambda: plain(*fa, **kw), iters=10)
    bound, by = kc.bound_ms(*kc.attention_work("v2", 128, B_SPAN, TRAIN_MEM,
                                               TRAIN_MEM, False))
    res["span_v2"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": None,
                      "library_call": none, "shape": shape}
    args = ba(*fwd(*fa, **kw))
    ms, plain_ms = kc.time_in_turns(lambda: bwd(*args, **kw),
                                    lambda: bwd_p(*args, **kw), iters=10)
    bound, by = kc.bound_ms(*kc.attention_work(
        "v2", 128, B_SPAN, TRAIN_MEM, TRAIN_MEM, False, backward=True))
    res["span_bwd_v2"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                          "bound_by": by, "library_ms": None,
                          "library_call": none, "shape": shape}
    del fa, ba, args
    torch.cuda.empty_cache()
    phase("numbers.spanbert_kernels", card=card,
          **{k: v for k, v in res.items()})
    return res


def measure_bert_pretrain(card: str) -> None:
    """bf16 MLM steps at the pretrainer's defaults (16 rows of 512 tokens,
    5 layers, hidden 768) on the smoke's MLM corpus: ms a step (host clock
    around 10 steps ending in a sync, after 3 warm-up steps) and tokens/s."""
    from transformer_gan_torch.bert.mlm import MlmTrainer
    from transformer_gan_torch.config import PACKAGED_VOCAB
    work = os.path.join(ROOT, "build", "chip_smoke", "bert")
    tr = MlmTrainer(os.path.join(work, "data"), os.path.join(work, "timing"),
                    PACKAGED_VOCAB, compute_dtype="bfloat16", device="cuda")
    batch = torch.from_numpy(tr.train_blocks[:tr.batch_size]).to(tr.device)
    for _ in range(3):
        tr.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(10):
        loss = tr.train_step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 10 * 1e3
    tokens = tr.batch_size * tr.block_size
    phase("numbers.bert_pretrain", card=card, dtype="bfloat16",
          rows=tr.batch_size, block=tr.block_size, ms_per_step=ms,
          tokens_per_s=tokens / (ms / 1e3), loss=float(loss),
          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)



def measure_variants(kc, card: str) -> None:
    """The config variants' costs in bf16 on the card: the MLE step (B 128,
    tgt 128, M 1024, dropout 0.1; host clock over 3 steps ending in a sync,
    after one warm-up step) on the K/V cache (K1f / K1b), on the raw-hidden
    memory (plain attention, QKV over [memory; segment]), with note-status
    inputs and with remat, each with its peak device memory; and generation
    us/token at M 4146 on a full ring (B 1 and 8, top-k; 64 tokens after a
    32-token warm-up): the cache on K3 against the raw memory's rolling
    loop."""
    from transformer_gan_torch.infer import sample as sampling
    from transformer_gan_torch.models import xl
    B, tgt = 128, 128
    line = {}
    for name, kw in (("cached", {}), ("raw", {"cache_kv": False}),
                     ("note_status", {"status": True}),
                     ("remat", {"remat": True})):
        case = kc.TrainCase(B=B, tgt=tgt, M=TRAIN_MEM, **kw)
        case.steps(1)
        torch.cuda.reset_peak_memory_stats()
        sec = case.steps(3)
        line[f"mle_{name}"] = {"ms": sec * 1e3, "tokens_per_s": B * tgt / sec,
                               "peak_gib": torch.cuda.max_memory_allocated()
                               / 2 ** 30}
        del case
        torch.cuda.empty_cache()
    scfg = sampling.SamplingConfig(technique="topk", topk=32, temperature=0.95)
    gen = torch.Generator(device="cuda:0").manual_seed(3)
    for cache_kv in (True, False):
        cfg = xl.XLConfig(**{**kc.BASELINE, "compute_dtype": "bfloat16",
                             "cache_kv": cache_kv})
        params = {k: v.cuda() for k, v in xl.init_xl_params(
            cfg, seed=0, base_init=("normal", 0.02)).items()}
        for lanes in (1, 8):
            mems = xl.init_mems(cfg, kc.MEM_LEN, lanes, device="cuda:0")
            mems = xl.XLMems(hids=torch.randn(
                mems.hids.shape, generator=gen, device="cuda:0").to(
                    mems.hids.dtype), count=kc.MEM_LEN)
            first = torch.full((lanes,), 7, dtype=torch.long, device="cuda:0")
            g = sampling.gumbel_noise((64, lanes, cfg.n_token), gen, "cuda:0")
            sampling.sample_scan(params, cfg, scfg, first, mems, 32, g[:32])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sampling.sample_scan(params, cfg, scfg, first, mems, 64, g)
            torch.cuda.synchronize()
            key = "cached_K3" if cache_kv else "raw_rolling"
            line[f"generate_{key}_B{lanes}"] = {
                "us_per_token": (time.perf_counter() - t0) / 64 * 1e6,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    phase("numbers.variants", card=card, dtype="bfloat16", B=B, tgt=tgt,
          M=TRAIN_MEM, gen_M=kc.MEM_LEN, **line)


# ---------------------------------------------------------------------------
# PPO at the spanbert op-point and the quality metrics
# ---------------------------------------------------------------------------

# experiment_spanbert.yml under DISCRIMINATOR.BERT.loss_type ppo (PPO's
# defaults: dis_D a second 5 x 768 BERT grafted from the same MLM
# checkpoint, clip 0.4, P0 every 20 steps): the gen phase adds one
# classifier update, a forward-only sampling pass (K4) and dis_D's forward
# and backward a micro-batch, and dis_D's scoring of every fake chunk.
PPO_BERT = {"loss_type": "ppo"}
# The metrics' op-point: the baseline model samples 2048-token pieces from
# <S> on a 2048-slot ring (count 0 -> 2047) with gumbel-argmax, K3's
# "gumbel" technique without same_length, in waves of up to 32 lanes; the
# sample counts cut from the shipped 640 / 2560 / 256 to multiples of the
# wave.
METRICS_SEQ = 2048
METRICS_WAVES = (8, 16, 32)
METRICS_COUNTS = (0, 32, METRICS_SEQ - 32)
METRICS_SAMPLES = {"bleu_num_samples": 64, "self_bleu_num_samples": 256,
                   "gen_num_samples": 64}
SHIPPED_SAMPLES = {"bleu_num_samples": 640, "self_bleu_num_samples": 2560,
                   "gen_num_samples": 256}


# The card-vs-CPU updates at the spanbert op-point (spanbert and PPO) run
# the generator at REF_LAYERS of its 6 layers, its width unchanged: at 6
# each took 70-180 s of the smoke on H100 hosts, most of it the CPU's plain
# update, and the whole smoke read 1095 s of its 1200 on one (PERF.md).
REF_LAYERS = 3


def ref_depth(case: dict) -> dict:
    """``case`` (GanCase's arguments) with the generator cut to
    REF_LAYERS layers."""
    case["overrides"]["MODEL"] = {"num_layers": REF_LAYERS}
    return case


def ppo_case(bert_ckpt: str) -> dict:
    """kernel_check.GanCase's arguments for the spanbert config under ppo
    with the smoke's MLM checkpoint as the critic and dis_D."""
    case = spanbert_case(bert_ckpt)
    case["overrides"]["DISCRIMINATOR"]["BERT"].update(PPO_BERT)
    return case


def check_generate_gumbel(kc) -> dict:
    """K3 on the metrics' route (gumbel-argmax, same_length off) against its
    plain version at B 8, 16 and 32, M 2048, counts 0, 32 and 2016 (the
    first chunk on an empty ring, the last on a full one), a 32-token chunk
    then a 31-token one (2047 = 63 x 32 + 31): fp32 ids identical, bf16 by
    the first step's logits within LOGIT_ULPS_BF16 of the split and the
    unsplit plain versions (the ids up to the first divergence)."""
    errs, cases = {}, []
    for dtype in ("float32", "bfloat16"):
        for B in METRICS_WAVES:
            for count in METRICS_COUNTS:
                res = kc.check_generate(dtype, B, count, chunks=(32, 31),
                                        M=METRICS_SEQ, technique="gumbel",
                                        same_length=False)
                cases.append({k: res[k] for k in ("dtype", "B", "count", "ok",
                                                  "max_abs_err")}
                             | {"chunks": [{k: c[k] for k in c if k != "count"}
                                           for c in res["chunks"]]})
                if not res["ok"]:
                    fail(f"K3 disagrees on the gumbel route: {res}")
                errs[dtype] = max(errs.get(dtype, 0.0), res["max_abs_err"])
        torch.cuda.empty_cache()
    phase("kernels.generate_gumbel", M=METRICS_SEQ, technique="gumbel",
          same_length=False, cases=cases, max_abs_err=errs)
    return errs


def run_ppo_path(_native, mle_run: str, bert_ckpt: str) -> dict:
    """The training CLI on experiment_spanbert.yml under ppo at the op-point
    (batch 128, warm start from the MLE run, the critic and dis_D from the
    MLM checkpoint, GAN phases from step 1), 3 steps and --restart for a
    4th (K4, K6, K1f / K1b). Each run: the critic's trunk bitwise the
    checkpoint's, dis_D's leaves moved (its embeddings and all its layers;
    nothing of it is frozen), the classifier updated once a gen phase.
    Returns the launch counts."""
    from transformer_gan_torch.models import bert as bert_mod
    from transformer_gan_torch.train import checkpoint as ckpt
    warm = os.path.join(mle_run, "checkpoint_last")
    disc = {"start_iter": 0, "dis_loss_freq": 1, "gen_loss_freq": 1,
            "BERT": {"model_path": bert_ckpt, **PPO_BERT}}
    mlm = ckpt.load_bert_params(bert_ckpt)

    def check(tr, name):
        ph = tr.gan
        live = {k: v.detach().cpu() for k, v in ph.dis_params().items()}
        same = all(torch.equal(live[k], mlm[k])
                   for k in bert_mod.trunk_names(live))
        disD = {k: v.detach().cpu() for k, v in ph.disD_params().items()}
        moved = [k for k in bert_mod.trunk_names(disD)
                 if not torch.equal(disD[k], mlm[k])]
        layers_moved = {k.split(".")[1] for k in moved
                        if k.startswith("layers.")}
        if (not same or not ph.gcfg.ppo or ph.disD_opt.trainable is not None
                or len(layers_moved) != ph.disD_cfg.num_hidden_layers
                or "word_embeddings" not in moved or not ph.P0_initialized
                or ph.disD_opt_state.count != ph.gen_opt_state.count):
            fail(f"the PPO run {name}: critic trunk bitwise {same}, dis_D "
                 f"moved {moved}, classifier updates "
                 f"{ph.disD_opt_state.count}, gen updates "
                 f"{ph.gen_opt_state.count}")
        return {"critic_trunk_bitwise_equal": same,
                "dis_D_trunk_leaves_moved": len(moved),
                "dis_D_layers_moved": sorted(layers_moved),
                "classifier_updates": ph.disD_opt_state.count,
                "P0": [float(x) for x in ph.P0[:4]]}

    total, runs = _gan_cli_runs(_native, "ppo", "experiment_spanbert.yml",
                                SPAN_OVERRIDES, disc, warm, check=check,
                                runs=GAN_RUNS[:1])
    payload = ckpt.load_gan_payload(
        os.path.join(ROOT, runs["chunk_res"]["run_dir"]), "checkpoint_last")
    if "disD_params" not in payload or "disD_opt_state" not in payload:
        fail("the PPO run checkpointed no dis_D")
    phase("main_path.ppo", overrides=SPAN_OVERRIDES, discriminator=disc,
          warm_start=os.path.relpath(warm, ROOT), **runs)
    return total


def run_metrics_path(_native, mle_run: str, bert_ckpt: str) -> tuple:
    """The training CLI on the baseline config (batch 128, warm start from
    the MLE run) for one step and an eval with BLEU, self-BLEU and the
    classifier on at gen_seq_len 2048 (METRICS_SAMPLES; the MLM
    checkpoint as the classifier's BERT): the eval line's scores finite,
    self-BLEU below 1, K3 on the bf16 chain. Returns (launch counts, the
    run directory, the eval's record)."""
    import math
    import re

    from transformer_gan_torch.cli import train as tcli
    from transformer_gan_torch.train.loop import wave_width
    work = os.path.join(ROOT, "build", "chip_smoke", "metrics")
    os.makedirs(work, exist_ok=True)
    data = os.path.join(ROOT, "build", "chip_smoke", "train", "data")
    metrics = {"use_bleu": True, "use_self_bleu": True,
               "gen_seq_len": METRICS_SEQ, "gen_batch_size": 128,
               "bleu_num_samples": METRICS_SAMPLES["bleu_num_samples"],
               "self_bleu_num_samples": METRICS_SAMPLES["self_bleu_num_samples"],
               "CLASSIFIER": {"use_classifier": True, "gen_batch_size": 128,
                              "gen_seq_len": METRICS_SEQ,
                              "gen_num_samples":
                                  METRICS_SAMPLES["gen_num_samples"],
                              "model_path": bert_ckpt}}
    cfg = _train_cfg_file(work, "metrics.yml", max_step=1, log_interval=1,
                          eval_interval=1, batch_size=B_TRAIN,
                          load_from_previous=os.path.join(mle_run,
                                                          "checkpoint_last"),
                          METRICS=metrics)
    torch.cuda.synchronize()
    _native.reset_launches()
    t0 = time.perf_counter()
    tr = tcli.main(["--data_dir", data, "--cfg", cfg, "--work_dir",
                    os.path.join(work, "run")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    with open(os.path.join(tr.work_dir, "train_rank0.log")) as f:
        line = [l for l in f.read().splitlines() if "Eval step" in l][0]
    bleu, self_bleu = ([float(x) for x in re.search(
        rf" {k}=\[([^\]]*)\]", line)[1].split(",")]
        for k in ("bleu", "self_bleu"))
    acc = float(line.split("class_acc=")[1])
    res = {"run_dir": os.path.relpath(tr.work_dir, ROOT), "wall_s": wall,
           "samples": METRICS_SAMPLES, "gen_seq_len": METRICS_SEQ,
           "wave": wave_width(METRICS_SAMPLES["bleu_num_samples"],
                              tr.cfg.METRICS.gen_batch_size),
           "generation_calls": tr._gen_wave,
           "bleu": bleu, "self_bleu": self_bleu, "classifier_accuracy": acc,
           "timing": tr.metrics_timing, "launches": launches}
    phase("main_path.metrics", **res)
    if (not all(math.isfinite(x) for x in bleu + self_bleu + [acc])
            or not all(x < 1.0 for x in self_bleu) or not 0 <= acc <= 1
            or launches["generate_chunk_tc"] == 0):
        fail(f"the metrics eval: {res}")
    return launches, tr.work_dir, res


def run_bert_score(pieces: str, bert_ckpt: str, n_files: int) -> dict:
    """``python -m transformer_gan_torch.metrics.bert_score`` on the
    ``n_files`` generated pieces with the MLM checkpoint, the first 512
    tokens of each (one block a file; 16 files at the CLI's 2048 took 50.8
    s on an H100): a finite negative mean."""
    import math
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "transformer_gan_torch.metrics.bert_score",
         "--model_path", bert_ckpt, "--input_dir", pieces,
         "--len_tokens_evaluated", "512"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    res = {"rc": out.returncode, "wall_s": wall, "output": lines[-5:],
           "stderr": out.stderr[-2000:] if out.returncode else ""}
    phase("main_path.bert_score", **res)
    mean = (float(lines[-1].rsplit(":", 1)[1])
            if out.returncode == 0 and lines else float("nan"))
    if not (math.isfinite(mean) and mean < 0
            and f"over {n_files} files" in lines[-1]):
        fail(f"bert_score on the generated pieces: {res}")
    res["mean"] = mean
    return res


# ---------------------------------------------------------------------------
# The config variants: note status, raw-hidden memory, remat, the profiler
# trace, tools.gen_npy_samples
# ---------------------------------------------------------------------------

# Which kernels each variant's CLI runs must launch (JAX's own routes): the
# note-status MLE on K1f / K1b; its generation K1f at the prime and no K3
# (the kernel takes no status inputs); nothing at all on the raw-hidden
# memory and the rolling GAN sampler (plain torch, as in the JAX package)
KERNELS = ("xl_attn_fwd_v2", "xl_attn_bwd_v2", "xl_attn_fwd_v1",
           "xl_attn_bwd_v1", "generate_chunk", "decode_chunk", "decode_step",
           "chain_bwd_res", "chain_bwd_recompute")
VARIANT_GEN_LENGTH = 256
NO_DROPOUT = {"dropout": 0.0, "attention_dropout": 0.0}


def _variant_train(_native, work: str, name: str, base: str = None,
                   restart_steps: int = 0, **groups):
    """The training CLI on ``base`` (the baseline config) with ``groups``
    (as ``_train_cfg_file``) over the training phase's corpus; with
    ``restart_steps``, then ``--restart`` for that many more. Returns (the
    trainer, its launches, seconds, peak device bytes)."""
    from transformer_gan_torch.cli import train as tcli
    data = os.path.join(ROOT, "build", "chip_smoke", "train", "data")
    cfg = _train_cfg_file(work, f"{name}.yml",
                          base or "experiment_baseline.yml", **groups)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    t0 = time.perf_counter()
    tr = tcli.main(["--data_dir", data, "--cfg", cfg, "--work_dir",
                    os.path.join(work, name)])
    if restart_steps:
        steps = tr.train_step_num + restart_steps
        cfg2 = _train_cfg_file(work, f"{name}_restart.yml",
                               base or "experiment_baseline.yml",
                               **{**groups, "max_step": steps})
        tr = tcli.main(["--data_dir", data, "--cfg", cfg2, "--work_dir",
                        tr.work_dir, "--restart"])
        if tr.train_step_num != steps:
            fail(f"--restart of {name} reached step {tr.train_step_num}")
    torch.cuda.synchronize()
    return (tr, dict(_native.LAUNCHES), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def _variant_generate(_native, work: str, name: str, run_dir: str) -> dict:
    """``cli.generate`` from a run directory with both inference configs
    (M 4146, VARIANT_GEN_LENGTH tokens: 8 unconditional lanes, and the
    conditional run with its debug check, incremental == batch). Returns
    each run's record and the launches of both."""
    from transformer_gan_torch.cli import generate as gcli
    from transformer_gan_torch.config import PACKAGED_VOCAB, inference_config
    vocab, _ = gcli.load_vocab(PACKAGED_VOCAB)
    torch.cuda.synchronize()
    _native.reset_launches()
    res = {}
    for run, path, over in (
            ("unconditional", "inference_unconditional.yml",
             {"num_midi_files": 8, "debug": False}),
            ("conditional_debug", "inference_conditional.yml",
             {"num_midi_files": 1, "debug": True})):
        c = inference_config(os.path.join("inference_config", path))
        c.EVENT.vocab_file_path = PACKAGED_VOCAB
        c.MODEL.model_directory = run_dir
        c.MODEL.debug = over["debug"]
        c.INPUT.num_midi_files = over["num_midi_files"]
        c.OUTPUT.output_txt_directory = os.path.join(work, f"{name}_{run}")
        c.GENERATION.generation_length = VARIANT_GEN_LENGTH
        gen = torch.Generator(device="cuda:0").manual_seed(1111)
        t0 = time.perf_counter()
        summary = gcli.main(c, "cuda:0", gen)
        torch.cuda.synchronize()
        n_prefix = c.INPUT.num_conditional_tokens if over["debug"] else 0
        for fp in summary["files"]:
            with open(fp) as f:
                toks = [l.strip() for l in f if l.strip()]
            if (len(toks) != VARIANT_GEN_LENGTH + n_prefix
                    or any(t not in vocab for t in toks)):
                fail(f"{name} generation {fp}: {len(toks)} tokens")
        res[run] = {"files": len(summary["files"]),
                    "wall_s": time.perf_counter() - t0,
                    "generate_s": summary["generate_seconds"],
                    "tokens": summary["tokens"],
                    "us_per_token": 1e6 * summary["generate_seconds"]
                    / (summary["tokens"] / len(summary["files"]))}
    res["launches"] = dict(_native.LAUNCHES)
    return res


def _need(label: str, launches: dict, positive=(), zero=()) -> None:
    for k in positive:
        if launches[k] == 0:
            fail(f"{label} never launched {k}")
    for k in zero:
        if launches[k] != 0:
            fail(f"{label} launched {k} {launches[k]} times (JAX's route runs "
                 "no kernel there)")


def run_variants_path(_native, mle_run: str, metrics_run: str,
                      bert_ckpt: str) -> dict:
    """main_path.variants: the config branches at full width through the
    CLIs, each with the launch counts JAX's routes give it, and the card
    against the CPU where the math differs from the kernel path's."""
    import math

    import numpy as np
    from transformer_gan_torch import kernel_check as kc
    from transformer_gan_torch.tools import gen_npy_samples
    work = os.path.join(ROOT, "build", "chip_smoke", "variants")
    os.makedirs(work, exist_ok=True)
    t_start = time.perf_counter()
    total = dict.fromkeys(_native.LAUNCHES, 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    # note status: MLE on K1f / K1b, a restart, generation without K3
    tr, launches, wall, peak = _variant_train(
        _native, work, "note_status", restart_steps=2,
        **{**TRAIN_OVERRIDES, "append_note_status": True})
    _need("the note-status run", launches,
          positive=("xl_attn_fwd_v2", "xl_attn_bwd_v2", "xl_attn_fwd_v2_tc",
                    "xl_attn_bwd_v2_tc"))
    log = _train_log(tr.work_dir)
    if not (log["val_nll"] and all(math.isfinite(x["nll"])
                                   for x in log["train"])):
        fail(f"the note-status run logged no finite NLL: {log}")
    add(launches)
    gen = _variant_generate(_native, work, "note_status", tr.work_dir)
    _need("note-status generation", gen["launches"],
          positive=("xl_attn_fwd_v2",),
          zero=("generate_chunk", "generate_chunk_tc"))
    add(gen["launches"])
    ref = check_train_reference(status=True)
    phase("main_path.variants.note_status", steps=tr.train_step_num,
          vec_len=tr.xcfg.vec_len, wall_s=wall, peak_bytes=peak,
          launches=launches, generate=gen, train_reference=ref, **log)
    if not ref["ok"]:
        fail("card and CPU disagree on the note-status MLE steps")

    # raw-hidden memory: MLE, generation at M 4146, the cnn GAN on the
    # rolling sampler; no kernel anywhere
    tr, launches, wall, peak = _variant_train(
        _native, work, "raw", **{**TRAIN_OVERRIDES, "max_step": 4,
                                 "eval_interval": 4},
        TPU={"cache_kv": False})
    _need("the raw-memory run", launches, zero=KERNELS)
    log = _train_log(tr.work_dir)
    if tr.state.mems[0].hids.dim() != 4 or not log["val_nll"]:
        fail(f"the raw-memory run: {log}")
    add(launches)
    gen_raw = _variant_generate(_native, work, "raw", tr.work_dir)
    _need("raw-memory generation", gen_raw["launches"], zero=KERNELS)
    add(gen_raw["launches"])
    disc = {"dis_loss_freq": 1, "gen_loss_freq": 1}
    gan_launches, gan_runs = _gan_cli_runs(
        _native, "variants_gan", "experiment_cnn.yml", GAN_OVERRIDES, disc,
        os.path.join(mle_run, "checkpoint_last"),
        runs=(("rolling_raw", {"cache_kv": False}, None, ()),))
    _need("the cnn GAN on raw memory", gan_launches, zero=KERNELS)
    add(gan_launches)
    ref = check_train_reference(cache_kv=False, steps=1)
    gan_ref = kc.check_gan_reference(overrides={"TPU": {"cache_kv": False}})
    phase("main_path.variants.raw", steps=tr.train_step_num, wall_s=wall,
          peak_bytes=peak, launches=launches, generate=gen_raw,
          gan=gan_runs, train_reference=ref, gan_reference=gan_ref, **log)
    if not ref["ok"] or not gan_ref["ok"]:
        fail("card and CPU disagree on the raw-memory MLE step or the "
             "rolling GAN updates")

    # remat: the logged losses equal a run without it at dropout 0
    remat = {}
    for on in (False, True):
        tr, launches, wall, peak = _variant_train(
            _native, work, f"remat_{on}",
            **{**TRAIN_OVERRIDES, "max_step": 5, "log_interval": 1,
               "eval_interval": 100},
            MODEL=NO_DROPOUT, TPU={"remat": on})
        remat[on] = {"nll": [x["nll"] for x in _train_log(tr.work_dir)["train"]],
                     "wall_s": wall,
                     "peak_bytes": peak, "launches": launches}
        add(launches)
    if (remat[True]["nll"] != remat[False]["nll"]
            or len(remat[True]["nll"]) != 5):
        fail(f"remat moved the logged losses: {remat}")
    phase("main_path.variants.remat", **{f"remat_{k}": v
                                         for k, v in remat.items()})

    # the profiler trace of steps 10-15 holds K1f's and K1b's kernels
    prof = os.path.join(work, "profile")
    tr, launches, wall, _ = _variant_train(
        _native, work, "profile",
        **{**TRAIN_OVERRIDES, "max_step": 16, "eval_interval": 100},
        TPU={"profile_dir": prof})
    with open(os.path.join(prof, "trace_rank0.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    found = {k: sum(k in n for n in names) for k in (
        "xl_attn_fwd_v2_tc_kernel", "xl_attn_bwd_v2_tc_rows",
        "xl_attn_bwd_v2_tc_keys")}
    add(launches)
    phase("main_path.variants.profile", events=len(events),
          kernel_names=len(names), found=found, wall_s=wall)
    if not all(found.values()):
        fail(f"the profiler trace lacks K1f / K1b: {found}")

    # tools.gen_npy_samples at the JAX tool's defaults on the metrics run,
    # then bert_score on its directory
    pieces = os.path.join(work, "pieces")
    torch.cuda.synchronize()
    _native.reset_launches()
    t0 = time.perf_counter()
    n = gen_npy_samples.main(["--model_dir", metrics_run, "--out", pieces])
    torch.cuda.synchronize()
    npy = {"files": n, "wall_s": time.perf_counter() - t0,
           "launches": dict(_native.LAUNCHES)}
    arrs = [np.load(os.path.join(pieces, f"sample_{k:04d}.npy"))
            for k in range(n)]
    if (n != 16 or any(a.shape != (2048,) or a.dtype != np.int32 or a[0] != 0
                       for a in arrs)):
        fail(f"gen_npy_samples: {npy}")
    _need("gen_npy_samples", npy["launches"],
          positive=("generate_chunk", "generate_chunk_tc"))
    add(npy["launches"])
    phase("main_path.variants.gen_npy_samples", **npy)
    score = run_bert_score(pieces, bert_ckpt, n)
    phase("main_path.variants", launches=total, score_mean=score["mean"],
          seconds=time.perf_counter() - t_start)
    return total


# ---------------------------------------------------------------------------
# The trajectory tools: MLE and GAN runs, kernel route against plain route
# ---------------------------------------------------------------------------

# The bands were stated in PERF.md before the first card run. MLE:
# every train and val NLL of a run against the fp32 plain route's; the
# control (TRAIN.warmup_step 0, under the inv_sqrt rule the lr falls to
# lr_min after the first update) must land beyond the bf16 band. GAN: every
# logged dis and gen loss of the fp32 kernel routes against the fp32 plain
# route's, and the weights by the drift rule of
# tests/test_torch_gan_parity.py (within 2 n lr after n Adam updates, at
# most 5% of them beyond 0.1 lr).
TRAJ_STEPS, TRAJ_EVAL_EVERY, TRAJ_PHASES = 150, 50, 6
TRAJ_TOL = {"mle_f32": 1e-3, "mle_bf16": 5e-2, "gan_f32": 1e-4,
            "drift_share": 0.05}


def _traj_run(_native, fn) -> tuple:
    """``fn()`` with the launch counters set to 0 just before; returns
    (its result, seconds, the counters that moved)."""
    torch.cuda.synchronize()
    _native.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            {k: v for k, v in _native.LAUNCHES.items() if v})


def run_trajectory_check(_native) -> dict:
    """check.trajectory: ``tools.convergence_parity`` at the baseline
    widths (2 layers, B 32, tgt 128, M 256; 150 steps, an eval every 50)
    from one set of weights on one stream: the fp32 plain route (the
    reference), the fp32 kernel route (K1f, K1b), the bf16 kernel route and
    the control; ``tools.gan_parity`` on the cached layout at the cnn
    widths (2 layers, B 16, tgt 64, mem 64, context 5; 6 phase pairs) on
    one set of recorded batches and uniforms: the fp32 plain route, the
    fp32 kernel route (K4, K6), the same on the per-token sampler and the
    recomputing chain (K5, K7), and the bf16 kernel route (its losses
    recorded, held to finiteness only: bf16 argmax near-ties change the
    samples). Each run's launches are read, zeros included."""
    import math
    import shutil

    import numpy as np
    from transformer_gan_torch.tools import convergence_parity as cp
    from transformer_gan_torch.tools import gan_parity as gp
    t_start = time.perf_counter()
    total = dict.fromkeys(_native.LAUNCHES, 0)

    def need(label, launches, positive):
        """The kernels a kernel-route run must launch; a plain-route run
        (no ``positive``) launches none."""
        missing = [k for k in positive if not launches.get(k)]
        if missing:
            fail(f"{label} never launched {missing}: {launches}")
        if not positive and launches:
            fail(f"{label} on the plain route launched {launches}")
        for k, v in launches.items():
            total[k] += v

    # MLE
    w = cp.WIDTHS["baseline"]
    train_p, val_p = cp.make_corpus(0, w["n_train"], w["n_val"])
    train_b, val_b, pad = cp.record_batches(train_p, val_p, TRAJ_STEPS,
                                            width="baseline")
    init = cp.init_params("baseline")
    mle = {}
    for name, kw, positive in (
            ("plain_f32", {"route": "plain"}, ()),
            ("kernel_f32", {}, ("xl_attn_fwd_v2", "xl_attn_bwd_v2")),
            ("kernel_bf16", {"dtype": "bfloat16"},
             ("xl_attn_fwd_v2", "xl_attn_bwd_v2", "xl_attn_fwd_v2_tc",
              "xl_attn_bwd_v2_tc")),
            ("control_warmup_0", {"warmup": 0},
             ("xl_attn_fwd_v2", "xl_attn_bwd_v2"))):
        (tr, va), secs, launches = _traj_run(_native, lambda: cp.run_port(
            train_b, val_b, pad, TRAJ_EVAL_EVERY, init, "adam",
            device="cuda:0", cache_kv=True, width="baseline", **kw))
        need(f"the {name} MLE trajectory", launches, positive)
        mle[name] = {"train_nll": tr, "val_nll": va, "seconds": secs,
                     "launches": launches}
    ref = mle["plain_f32"]
    for name, run in mle.items():
        if not all(map(math.isfinite, run["train_nll"] + run["val_nll"])):
            fail(f"the {name} MLE trajectory is not finite: {run}")
        if name != "plain_f32":
            run["gap"] = max(cp.max_gap(run["train_nll"], ref["train_nll"]),
                             cp.max_gap(run["val_nll"], ref["val_nll"]))
    mle_ok = (mle["kernel_f32"]["gap"] <= TRAJ_TOL["mle_f32"]
              and mle["kernel_bf16"]["gap"] <= TRAJ_TOL["mle_bf16"]
              and mle["control_warmup_0"]["gap"] > TRAJ_TOL["mle_bf16"])

    # GAN
    data_dir = os.path.join(ROOT, "build", "chip_smoke", "trajectory", "gan")
    shutil.rmtree(data_dir, ignore_errors=True)
    recorded, noises = gp.make_data(TRAJ_PHASES, data_dir, width="cnn")
    gen_init, dis_init = gp.init_weights(gp.make_cfg(False, True, "cnn"))
    gan = {}
    for name, dtype, route, tpu, env, positive in (
            ("plain_f32", "float32", "plain", {}, None, ()),
            ("kernel_f32", "float32", "kernel", {}, None,
             ("decode_chunk", "chain_bwd_res")),
            ("kernel_f32_step_recompute", "float32", "kernel",
             {"gan_chain_bwd": "kernel_recompute"}, "0",
             ("decode_step", "chain_bwd_recompute")),
            ("kernel_bf16", "bfloat16", "kernel", {}, None,
             ("decode_chunk", "decode_chunk_tc", "chain_bwd_res",
              "chain_bwd_res_tc"))):
        cfg = gp.make_cfg(False, True, "cnn", dtype).merge({"TPU": tpu})
        if env is not None:
            os.environ["TGTPU_CHUNK_SAMPLER"] = env
        (dis, gen, gen_w, dis_w), secs, launches = _traj_run(
            _native, lambda: gp.run_port(
                cfg, data_dir, recorded, gp.recorded_draws(noises, "cuda:0"),
                gen_init, dis_init, device="cuda:0", route=route))
        os.environ.pop("TGTPU_CHUNK_SAMPLER", None)
        need(f"the {name} GAN trajectory", launches, positive)
        if not all(map(math.isfinite, dis + gen)):
            fail(f"the {name} GAN trajectory is not finite: {dis} {gen}")
        gan[name] = {"dis_loss": dis, "gen_loss": gen, "seconds": secs,
                     "launches": launches, "weights": (gen_w, dis_w)}
    ref = gan["plain_f32"]
    ref_w = dict(zip(("gen", "dis"), ref.pop("weights")))
    lr = {"gen": gp.GEN_LR, "dis": gp.DIS_LR}
    for name, run in gan.items():
        if name == "plain_f32":
            continue
        run["gap"] = max(cp.max_gap(run["dis_loss"], ref["dis_loss"]),
                         cp.max_gap(run["gen_loss"], ref["gen_loss"]))
        run["drift"] = {
            net: {"max_over_n_lr": gp._max_drift(got, ref_w[net])
                  / (TRAJ_PHASES * lr[net]),
                  "share_beyond_0.1_lr": gp.drift_share(got, ref_w[net],
                                                        0.1 * lr[net])}
            for net, got in zip(("gen", "dis"), run.pop("weights"))}
    moved = {f"{k}_off_first": float(np.abs(np.asarray(ref[f"{k}_loss"])
                                            - ref[f"{k}_loss"][0]).max())
             for k in ("dis", "gen")}
    gan_ok = all(
        gan[name]["gap"] <= TRAJ_TOL["gan_f32"]
        and all(d["max_over_n_lr"] <= 2.0
                and d["share_beyond_0.1_lr"] <= TRAJ_TOL["drift_share"]
                for d in gan[name]["drift"].values())
        for name in ("kernel_f32", "kernel_f32_step_recompute"))
    res = {"mle": mle, "gan": gan, "gan_moved": moved, "tol": TRAJ_TOL,
           "mle_ok": mle_ok, "gan_ok": gan_ok, "launches": total,
           "seconds": time.perf_counter() - t_start}
    phase("check.trajectory", **res)
    if not mle_ok:
        fail("the MLE trajectories leave their bands, or the control does "
             "not")
    if not gan_ok:
        fail("the fp32 GAN kernel trajectories leave their band or the "
             "drift rule")
    return total


def measure_gan_ppo(kc, card: str, bert_ckpt: str) -> dict:
    """bf16 at the spanbert op-point under ppo (B 128 in 4 micro-batches of
    32, M 128): the dis phase (one update), the classifier phase (one dis_D
    update) and the gen phase (the classifier phase and the generator's
    update, off P0's frequency) in ms, kernel path against plain path in
    turns (plain, kernel, kernel, plain) after a kernel-path warm-up."""
    cases = {r: kc.GanCase("bfloat16", 128, "cuda", route=r, host_draws=False,
                           **ppo_case(bert_ckpt))
             for r in ("plain", "kernel")}
    for case in cases.values():        # time gen phases off P0's frequency
        case.phases.P0_initialized = True

    def phase_s(route, which):
        ph = cases[route].phases
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "clf":
            ph.classifier_phase(ph._next_dis_batch())
        else:
            getattr(ph, which + "_phase")(1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for which in ("dis", "clf", "gen"):
        phase_s("kernel", which)
    timed = {}
    for which in ("dis", "clf", "gen"):
        turns = [phase_s(r, which) for r in ("plain", "kernel", "kernel",
                                             "plain")]
        timed[which] = {"kernel_ms": (turns[1] + turns[2]) / 2 * 1e3,
                        "plain_ms": (turns[0] + turns[3]) / 2 * 1e3,
                        "turns_s": turns}
    phase("numbers.gan_ppo", B=128, lanes=B_SPAN, M=SPAN_MEM,
          dtype="bfloat16", card=card, dis_phase=timed["dis"],
          classifier_phase=timed["clf"], gen_phase=timed["gen"])
    del cases
    torch.cuda.empty_cache()
    return timed


def measure_metrics(kc, card: str, mle_run: str, eval_res: dict) -> dict:
    """The metrics' generation in bf16 on the MLE run's generator: generated
    tokens/s of one 2048-token piece a wave at 1, 2, 4, 8, 16 and 32 lanes
    (host clock ending in a sync, after a warm-up); K3 on the gumbel route,
    a 32-token chunk at B 32, M 2048 on a full ring, against its plain
    version in turns, beside its bound; the eval's seconds by part
    (main_path.metrics) and the same at the shipped 640 / 2560 / 256
    samples: generation and the classifier's features and SVM scaled by the
    samples (the features and the SVM by their blocks), BLEU and self-BLEU
    timed on the eval's pieces tiled to the shipped counts."""
    import random

    import numpy as np
    from transformer_gan_torch.config import training_config
    from transformer_gan_torch.infer import sample as sampling
    from transformer_gan_torch.metrics.bleu import BLEU
    from transformer_gan_torch.models import xl
    from transformer_gan_torch.train import checkpoint as ckpt
    cfg = training_config(os.path.join(ROOT, "training_config",
                                       "experiment_baseline.yml"))
    xcfg = xl.XLConfig.from_cfg(cfg, 310)
    params, _, _ = ckpt.load_checkpoint(mle_run, "checkpoint_last", "cuda:0")
    gen = torch.Generator(device="cuda:0").manual_seed(3)

    def piece_s(B):
        mems = xl.init_mems(xcfg, METRICS_SEQ, B, device="cuda:0")
        first = torch.zeros((B,), dtype=torch.int64, device="cuda:0")
        g = sampling.gumbel_draws(METRICS_SEQ - 1, B, 310, gen, "cuda:0")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = sampling.generate_tokens_gumbel(params, xcfg, METRICS_SEQ,
                                               first, mems, g)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, toks

    piece_s(1)                                  # warm-up
    widths = {}
    for B in (1, 2, 4, 8, 16, 32):
        sec, toks = piece_s(B)
        widths[B] = {"s_per_piece": sec, "tokens_per_s":
                     B * (METRICS_SEQ - 1) / sec,
                     "distinct_pieces": len({tuple(r) for r in
                                             toks.T.cpu().tolist()})}
    fastest = max(widths, key=lambda b: widths[b]["tokens_per_s"])

    case = kc.GenerateCase("bfloat16", 32, METRICS_SEQ - 32, M=METRICS_SEQ,
                           technique="gumbel", same_length=False)
    g = case.noise(32)
    ms, plain_ms = kc.time_in_turns(lambda: case.run(32, g),
                                    lambda: case.run(32, g, plain=True), 3)
    bound, by = kc.bound_ms(*kc.sampler_work(32, 32, METRICS_SEQ,
                                             METRICS_SEQ - 32))
    k3 = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
          "library_ms": None, "library_call": "none computes gumbel-argmax "
          "sampling through the decoder",
          "shape": f"32 tokens, B 32, M {METRICS_SEQ}, count "
                   f"{METRICS_SEQ - 32}, gumbel, same_length off, bf16"}
    del case

    t = eval_res["timing"]["eval"]
    clf = t["classifier"]
    gen_s = (t["generate_bleu_s"] + t["generate_self_bleu_s"]
             + t["generate_classifier_s"])
    n_now = sum(METRICS_SAMPLES.values())
    n_ship = sum(SHIPPED_SAMPLES.values())
    # the classifier's blocks: train 80% of each side (at most 5000), eval
    # the rest (at most 1000); generated pieces give 16 blocks of 128
    real = clf["n_blocks"] - _clf_blocks(METRICS_SAMPLES["gen_num_samples"])
    blocks_ship = real + _clf_blocks(SHIPPED_SAMPLES["gen_num_samples"])
    scale = blocks_ship / clf["n_blocks"]
    # the pieces tools.gen_npy_samples wrote from the metrics run (16)
    folder = os.path.join(ROOT, "build", "chip_smoke", "variants", "pieces")
    pieces = [np.load(os.path.join(folder, f)).tolist()
              for f in sorted(os.listdir(folder))]
    # the shipped counts of 2048-token pieces: the generated ones rotated
    n_bleu = SHIPPED_SAMPLES["bleu_num_samples"] // len(pieces)
    n_self = SHIPPED_SAMPLES["self_bleu_num_samples"] // len(pieces)
    bleu_hyps = [p[k:] + p[:k] for k in range(n_bleu) for p in pieces]
    self_hyps = [p[k:] + p[:k] for k in range(n_self) for p in pieces]
    data = os.path.join(ROOT, "build", "chip_smoke", "train", "data", "valid")
    real_text = [np.load(os.path.join(data, f)).tolist()
                 for f in sorted(os.listdir(data))]
    random.seed(0)
    t0 = time.perf_counter()
    BLEU("BLEU", test_text=bleu_hyps, real_text=real_text, gram=[2, 3, 4, 5],
         if_use=True).get_score()
    bleu_ship = time.perf_counter() - t0
    t0 = time.perf_counter()
    BLEU("Self-BLEU", test_text=self_hyps, real_text=bleu_hyps,
         gram=[2, 3, 4], if_use=True).get_score()
    self_ship = time.perf_counter() - t0
    shipped = {"generation_s": gen_s * n_ship / n_now, "bleu_s": bleu_ship,
               "self_bleu_s": self_ship,
               "features_s": clf["features_s"] * scale,
               "svm_s": clf["svm_s"] * scale}
    shipped["total_s"] = sum(shipped.values())
    line = {"card": card, "dtype": "bfloat16", "gen_seq_len": METRICS_SEQ,
            "wave_tokens_per_s": widths, "fastest_wave": fastest,
            "trainer_wave": eval_res["wave"], "K3_gumbel": k3,
            "eval_s_by_part": {"generation_s": gen_s,
                               "bleu_s": t["bleu_s"],
                               "self_bleu_s": t["self_bleu_s"],
                               "features_s": clf["features_s"],
                               "svm_s": clf["svm_s"],
                               "classifier_blocks": clf["n_blocks"]},
            "samples": METRICS_SAMPLES, "shipped_samples": SHIPPED_SAMPLES,
            "shipped_eval_s_by_part": shipped,
            "shipped_rule": "generation by samples; features and SVM by "
                            "blocks; BLEU and self-BLEU timed on tiled pieces"}
    phase("numbers.metrics", **line)
    del params
    torch.cuda.empty_cache()
    return {"gen_gumbel": k3}


def _clf_blocks(n_pieces: int) -> int:
    """The classifier's generated blocks (train and eval) from
    ``n_pieces`` 2048-token pieces in 128-token blocks."""
    n = n_pieces * (METRICS_SEQ // 128)
    k = int(0.8 * n)
    return min(k, 5000) + min(n - k, 1000)


# ---------------------------------------------------------------------------
# Data parallel: torchrun at world 1 on NCCL, two gloo ranks on the one card
# ---------------------------------------------------------------------------

DP_STEPS = 10               # a run, then as many after its --restart
DP_LAUNCH_NEED = (("xl_attn_fwd_v2",), ("xl_attn_bwd_v2",),
                  ("decode_chunk", "decode_step"),
                  ("chain_bwd_res", "chain_bwd_recompute"))


def _cli_launches(run_dir: str, rank: int = 0) -> dict:
    """The kernel launches rank ``rank`` of the training CLI logged, summed
    over its runs."""
    total = {}
    with open(os.path.join(run_dir, f"train_rank{rank}.log")) as f:
        for line in f:
            if "Kernel launches: " in line:
                for k, v in json.loads(line.split("Kernel launches: ", 1)[1]
                                       ).items():
                    total[k] = total.get(k, 0) + v
    return total


def _dp_cli_runs(work: str, data: str, cards: int) -> dict:
    """The training CLI on the baseline config (B 128 a rank, M 1024, bf16)
    for DP_STEPS steps and an eval, then --restart for DP_STEPS more and an
    eval: under ``torchrun --nproc_per_node 1``, without torchrun, and, when
    ``cards`` > 1, under ``torchrun --nproc_per_node cards``. Returns each
    run's directory, logged lines, each rank's launches and seconds."""
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node"]
    launchers = {"torchrun_nccl_world1": (torchrun + ["1"], 1),
                 "one_process": ([sys.executable], 1)}
    if cards > 1:
        launchers[f"torchrun_nccl_world{cards}"] = (torchrun + [str(cards)],
                                                    cards)
    runs = {}
    for name, (launcher, nproc) in launchers.items():
        over = {**TRAIN_OVERRIDES, "batch_size": B_TRAIN * nproc,
                "max_step": DP_STEPS, "log_interval": 5,
                "eval_interval": DP_STEPS}
        cfgs = (_train_cfg_file(work, f"{name}_first.yml", **over),
                _train_cfg_file(work, f"{name}_restart.yml",
                                **{**over, "max_step": 2 * DP_STEPS}))
        base = os.path.join(work, name)
        t0 = time.perf_counter()
        run_dir = None
        for cfg in cfgs:
            args = ["--data_dir", data, "--cfg", cfg, "--work_dir",
                    run_dir or base] + (["--restart"] if run_dir else [])
            out = subprocess.run(
                launcher + ["-m", "transformer_gan_torch.cli.train", *args],
                cwd=ROOT, capture_output=True, text=True, timeout=400)
            if out.returncode != 0:
                fail(f"{name} training run: rc {out.returncode}\n"
                     f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
            if run_dir is None:
                (stamp,) = os.listdir(base)
                run_dir = os.path.join(base, stamp)
        runs[name] = {"run_dir": run_dir, "wall_s": time.perf_counter() - t0,
                      "batch_size": B_TRAIN * nproc,
                      "launches": [_cli_launches(run_dir, r)
                                   for r in range(nproc)],
                      **_train_log(run_dir)}
    return runs


def _dp_compare(ranks: list, ref_mle: dict, ref_gan: dict) -> dict:
    """The ranks against one process on the same global batches: the
    MLE steps (equal lr: the step's gradient over all rows), and the cnn
    dis and gen update by the rule of the JAX suite's mesh test (the
    critic's move equal, the generator's once scaled by the world size,
    its lr being gen_lr / world), with the tolerances of the card-vs-CPU
    checks (TRAIN_REF_TOL, kernel_check.GAN_REF_TOL); the ranks' gen update
    starts from the one-process critic (``kernel_check.dp_rank``)."""
    from transformer_gan_torch import kernel_check as kc
    from transformer_gan_torch.parallel import sharding as psh
    from transformer_gan_torch.train import optim as topt
    world, tol, gtol = len(ranks), TRAIN_REF_TOL, kc.GAN_REF_TOL
    layout = ref_mle["layout"]
    res, ok = {"world": world}, True
    mle = {"loss_rel_err": 0.0, "grad_norm_rel_err": 0.0,
           "mu_rel_err": 0.0, "mu_leaf_max_rel_err": 0.0}
    for k, ref in enumerate(ref_mle["metrics"]):
        mets = [r["mle"]["metrics"][k] for r in ranks]
        loss = sum(m["loss_weighted"] for m in mets)
        mle["loss_rel_err"] = max(mle["loss_rel_err"], abs(
            loss - ref["loss_weighted"]) / abs(ref["loss_weighted"]))
        ok = ok and sum(m["tokens"] for m in mets) == ref["tokens"]
        for m in mets:
            mle["grad_norm_rel_err"] = max(mle["grad_norm_rel_err"], abs(
                m["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"])
        errs = kc._grad_errs(ranks[0]["mle"]["mu"][k], ref_mle["mu"][k],
                             layout, gtol["leaf_floor"])
        mle["mu_rel_err"] = max(mle["mu_rel_err"], errs["grad_rel_err"])
        mle["mu_leaf_max_rel_err"] = max(mle["mu_leaf_max_rel_err"],
                                         errs["grad_leaf_max_rel_err"])
    sched = topt.make_schedule("inv_sqrt", 0.004, 100000, 0.0001, 4000)
    lr = sum(0.004 * sched(k) for k in range(len(ref_mle["metrics"])))
    diff = (ranks[0]["mle"]["flat"] - ref_mle["flat"]).abs()
    mle.update(
        lr_sum=lr, param_max_abs_err=float(diff.max()),
        param_share_beyond=float((diff > gtol["move_rel"] * lr).float()
                                 .mean()),
        ranks_bitwise_equal=all(torch.equal(r["mle"]["flat"],
                                            ranks[0]["mle"]["flat"])
                                for r in ranks),
        mem_max_abs_err=max(float((r["mle"]["mem_last"] - psh.rank_rows(
            ref_mle["mem_last"], i, world, axis=2)).abs().max())
                            for i, r in enumerate(ranks)))
    ok = (ok and mle["loss_rel_err"] <= tol["loss_rel"]
          and mle["grad_norm_rel_err"] <= tol["grad_norm_rel"]
          and mle["mu_rel_err"] <= gtol["grad_rel"]
          and mle["mu_leaf_max_rel_err"] <= gtol["grad_leaf_rel"]
          and mle["param_max_abs_err"] <= 2 * lr
          and mle["param_share_beyond"] <= gtol["flip_share"]
          and mle["ranks_bitwise_equal"]
          and mle["mem_max_abs_err"] <= tol["mem_abs"])
    res["mle"] = mle
    gan = ranks[0]["gan"]
    g = {"loss_rel_err": max(abs(gan[n] - ref_gan[n]) / abs(ref_gan[n])
                             for n in ("gen_loss", "dis_loss")),
         "kinks": [r["gan"]["kinks"] for r in ranks]}
    ok = ok and g["loss_rel_err"] <= gtol["loss_rel"]
    for r in ranks:
        kinks = r["gan"]["kinks"]
        ok = (ok and kinks["kink_outside"] == 0
              and len(kinks["kink_units"]) <= gtol["kink_units"])
    for name, scale in (("dis", 1.0), ("gen", float(world))):
        errs = kc._grad_errs(gan["grads"][name], ref_gan["grads"][name],
                             ref_gan["layouts"][name], gtol["leaf_floor"])
        lr = ref_gan["lr"][name]
        diff = (gan["moves"][name] * scale - ref_gan["moves"][name]).abs()
        share = float((diff > gtol["move_rel"] * lr).float().mean())
        g[name] = {**errs, "lr": lr, "rank_lr": gan["lr"][name],
                   "move_scale": scale, "move_max_abs_err": float(diff.max()),
                   "move_share_beyond": share}
        ok = (ok and errs["grad_rel_err"] <= gtol["grad_rel"]
              and errs["grad_leaf_max_rel_err"] <= gtol["grad_leaf_rel"]
              and share <= gtol["flip_share"] and float(diff.max()) <= 2 * lr
              and abs(gan["lr"][name] * scale - lr) <= 1e-12 * lr)
    g["ranks_bitwise_equal"] = all(
        torch.equal(r["gan"]["moves"][n], gan["moves"][n])
        for r in ranks for n in ("dis", "gen"))
    res["gan"], res["ok"] = g, ok and g["ranks_bitwise_equal"]
    return res


def run_data_parallel_path(_native, card: str) -> dict:
    """(a) the training CLI under torchrun at world 1 on NCCL, DP_STEPS steps,
    an eval and a --restart for DP_STEPS more, bitwise equal to the CLI
    without torchrun (an all-reduce over one rank is exact); (b) two gloo
    ranks sharing the one card (NCCL refuses two ranks on one device): two
    fp32 MLE steps at the global B 128 (64 rows a rank, tgt 128, M 1024) and
    a cnn dis and gen update at the global B 64, each against one process
    on the same global batches (``_dp_compare``), K1f, K1b, K4 / K5 and K6 /
    K7 launched on each rank; then the bf16 MLE step's ms at one rank and at
    two sharing the card, and one all-reduce of the flat fp32 gradient on
    gloo (two ranks) and on NCCL (world 1). On a machine with N > 1 cards
    also: (a) the CLI on N ranks at B 128 a card (no one-process run has
    that global batch: held to finite NLLs, K1f and K1b on each rank, a
    restart) and (b) N NCCL ranks, one a card, held against one process as
    the two ranks are. Returns the launches of every rank of (a) and (b)."""
    import math

    from transformer_gan_torch import kernel_check as kc
    from transformer_gan_torch.parallel import mesh as pmesh
    from transformer_gan_torch.train.checkpoint import load_checkpoint
    t_start = time.perf_counter()
    cards = torch.cuda.device_count()
    work = os.path.join(ROOT, "build", "chip_smoke", "data_parallel")
    data = os.path.join(ROOT, "build", "chip_smoke", "train", "data")
    os.makedirs(work, exist_ok=True)
    runs = _dp_cli_runs(work, data, cards)
    pa, oa, _ = load_checkpoint(runs["torchrun_nccl_world1"]["run_dir"],
                                "checkpoint_last")
    pb, ob, _ = load_checkpoint(runs["one_process"]["run_dir"],
                                "checkpoint_last")
    bitwise = (set(pa) == set(pb) and all(torch.equal(pa[k], pb[k])
                                          for k in pa)
               and torch.equal(oa.mu, ob.mu) and torch.equal(oa.nu, ob.nu)
               and oa.count == ob.count == 2 * DP_STEPS)
    dist_runs = {k: r for k, r in runs.items() if k.startswith("torchrun")}
    finite = {}
    for name, r in dist_runs.items():
        _, opt, _ = load_checkpoint(r["run_dir"], "checkpoint_last")
        finite[name] = (opt.count == 2 * DP_STEPS and len(r["train"]) == 4
                        and all(math.isfinite(x["nll"]) for x in r["train"]))
    for r in runs.values():
        r["run_dir"] = os.path.relpath(r["run_dir"], ROOT)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ref_gan = kc._gan_update("float32", 64, "cuda:0")
    record = ref_gan.pop("ff_pre")
    torch.cuda.empty_cache()
    # each set of ranks: (world, device, backend)
    layouts = {"two_ranks_sharing_the_card": (2, "cuda:0", "gloo")}
    if cards > 1:
        layouts[f"{cards}_ranks_one_a_card"] = (cards, "cuda", "nccl")
    ranks, ranks_s = {}, {}
    for key, (world, device, backend) in layouts.items():
        t0 = time.perf_counter()
        ranks[key] = pmesh.spawn(kc.dp_rank, world, record,
                                 ref_gan["dis_flat"], device=device,
                                 backend=backend)
        ranks_s[key] = time.perf_counter() - t0
    del record
    ref_mle = kc.dp_mle_steps(device="cuda:0")
    cmp = {k: _dp_compare(r, ref_mle, ref_gan) for k, r in ranks.items()}
    one_rank = kc.TrainCase(B=128, dtype="bfloat16")
    one_rank.steps(2)
    step_1 = 1e3 * one_rank.steps(5)
    n_params = one_rank.state.flat.numel()
    del one_rank
    torch.cuda.empty_cache()
    (nccl_ms,) = pmesh.spawn(kc.dp_allreduce_ms, 1, n_params,
                             device="cuda:0", backend="nccl")
    launches = dict.fromkeys(_native.LAUNCHES, 0)
    missing = []
    for name, r in dist_runs.items():
        for i, rank_launches in enumerate(r["launches"]):
            for k, v in rank_launches.items():
                launches[k] += v
            missing += [(name, i, k) for k in ("xl_attn_fwd_v2",
                                               "xl_attn_bwd_v2")
                        if not rank_launches.get(k)]
    for key, rs in ranks.items():
        for i, r in enumerate(rs):
            for k in launches:
                launches[k] += r["launches"][k]
            missing += [(key, i, need) for need in DP_LAUNCH_NEED
                        if not any(r["launches"][k] for k in need)]
    res = {"cards": cards, "cli": runs,
           "world1_bitwise_equal_to_one_process": bitwise,
           "torchrun_nll_finite": finite, "ranks_wall_s": ranks_s,
           "compare": cmp,
           "rank_launches": {k: [r["launches"] for r in rs]
                             for k, rs in ranks.items()},
           "seconds": time.perf_counter() - t_start}
    phase("main_path.data_parallel", **res)
    if not bitwise:
        fail("the torchrun world-1 run is not bitwise the one-process run")
    if not all(finite.values()):
        fail(f"a torchrun run logged a non-finite NLL: {finite}")
    if missing:
        fail(f"a rank launched none of these kernels: {missing}")
    if not all(c["ok"] for c in cmp.values()):
        fail("the ranks disagree with one process on the same global batch")
    phase("numbers.data_parallel", card=card, dtype="bfloat16", B=B_TRAIN,
          tgt=128, M=TRAIN_MEM,
          mle_step_ms={"one_rank": step_1,
                       **{k: [r["bf16_step_ms"] for r in rs]
                          for k, rs in ranks.items()}},
          allreduce={"fp32_elements": n_params,
                     "mb": n_params * 4 / 1e6,
                     **{f"{rs[0]['backend']}_{k}_ms":
                        [r["allreduce_ms"] for r in rs]
                        for k, rs in ranks.items()},
                     "nccl_world1_ms": nccl_ms},
          cli_tokens_per_s={k: [x["tokens_per_s"] for x in r["train"]]
                            for k, r in runs.items()})
    return launches


if __name__ == "__main__":
    main()
