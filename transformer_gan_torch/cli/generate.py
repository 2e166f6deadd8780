"""Generation CLI of the port (counterpart of ``cli/generate.py``).

Same YAML surface and outputs: one token text file per generated piece in
``OUTPUT.output_txt_directory``, conditional "time extension" priming from a
token ``.npy`` (count- or duration-selected prefix), fixed-length generation
in waves of up to 8 lanes, the duration-based host loop, and the debug mode
that asserts incremental == batch memories and reports the prime NLL.

The model directory holds the training ``config.yml`` and the port's
parameter file ``<checkpoint_name>.pt`` (see ``convert.py``)::

    python -m transformer_gan_torch.cli.generate \\
        --inference_config inference_config/inference_conditional.yml
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from .._native import resolve_device
from ..config import (PACKAGED_VOCAB, inference_config, is_null,
                      training_config)
from ..convert import PARAMS_SUFFIX, load_params
from ..data.vocab import BaseVocab
from ..infer import sample as sampling
from ..models import xl

MAX_LANES = 8


def load_vocab(vocab_path: str = PACKAGED_VOCAB):
    """Token list and index of a vocab file (default: the packaged vocab,
    also ``EVENT.vocab_file_path``'s default). A missing file named
    ``performance_vocab.txt``, as the JAX package's relative default names
    it, falls back to the packaged vocab; any other missing path raises."""
    if (not os.path.exists(vocab_path)
            and os.path.basename(vocab_path) == "performance_vocab.txt"):
        print(f"vocab {vocab_path} not found; using packaged {PACKAGED_VOCAB}")
        vocab_path = PACKAGED_VOCAB
    with open(vocab_path, "r") as f:
        tokens_list = [line.strip() for line in f]
    tokens_list = [t for t in tokens_list if t]
    return tokens_list, {s: i for i, s in enumerate(tokens_list)}


def get_duration_from_token(event_representation, token_index, tokens_list):
    """TIME_SHIFT_k -> k * 10 ms."""
    if event_representation == "magenta":
        tok = tokens_list[token_index]
        if tok.startswith("TIME_SHIFT"):
            return int(tok.split("_")[-1]) * 0.01
        return None
    raise NotImplementedError


def _write_tokens(path, tokens_list, seq):
    with open(path, "w") as f:
        f.write("\n".join(tokens_list[t] for t in seq))


def main(inference_cfg, device=None, generator: torch.Generator | None = None):
    """Generate as the inference config says. ``device`` defaults to the
    CUDA card and raises without one (pass ``"cpu"`` for the CPU);
    ``generator`` (on ``device``) draws all sampling noise
    and defaults to one seeded with the training config's TRAIN.seed.
    Returns a summary: files written and generation time and tokens."""
    if inference_cfg.EVENT.event_representation != "magenta":
        raise NotImplementedError(
            "Newevent representation generations are yet to be implemented")
    device = resolve_device(device)
    model_dir = inference_cfg.MODEL.model_directory
    params_fp = os.path.join(model_dir, inference_cfg.MODEL.checkpoint_name
                             + PARAMS_SUFFIX)
    cfg_fp = os.path.join(model_dir, "config.yml")
    out_dir = inference_cfg.OUTPUT.output_txt_directory
    os.makedirs(out_dir, exist_ok=True)
    ext = ".txt"

    tokens_list, token2index = load_vocab(inference_cfg.EVENT.vocab_file_path)
    empty_bar_token = token2index["TIME_SHIFT_100"]

    cfg = training_config(cfg_fp)
    vocab = BaseVocab(tokens_list)
    if cfg.TRAIN.append_note_status:
        # the model carries status_emb; sampling feeds no status vectors,
        # as the JAX package's CLI
        vocab.notes_mapping()
    xcfg = xl.XLConfig.from_cfg(cfg, len(tokens_list), vocab.vec_len)
    params = load_params(params_fp, device)

    mem_len = int(inference_cfg.MODEL.memory_length)
    scfg = sampling.SamplingConfig.from_cfg(inference_cfg, empty_bar_token)
    decode_step = sampling.make_decode_step(xcfg, scfg)
    prime_step = sampling.make_prime_step(xcfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            int(cfg.TRAIN.seed))
    V = xcfg.n_token
    summary = {"files": [], "generate_seconds": 0.0, "tokens": 0}

    def generate(first, mems, length):
        g_all = sampling.gumbel_noise((length, first.shape[0], V), generator,
                                      device)
        t0 = time.perf_counter()
        tokens, mems = sampling.sample_scan(params, xcfg, scfg, first, mems,
                                            length, g_all)
        tokens = tokens.cpu()   # waits for the device
        summary["generate_seconds"] += time.perf_counter() - t0
        summary["tokens"] += tokens.numel()
        return tokens, mems

    # conditional "time extension" prefix
    num_conditional_tokens = 0
    conditional_data = None
    if inference_cfg.INPUT.time_extension and not is_null(
            inference_cfg.INPUT.conditional_input_melody):
        conditional_data = np.load(
            inference_cfg.INPUT.conditional_input_melody).tolist()
        print("* Loaded conditional file {}".format(
            inference_cfg.INPUT.conditional_input_melody))
        num_conditional_tokens = inference_cfg.INPUT.num_conditional_tokens
        if inference_cfg.GENERATION.duration_based:
            duration = 0.0
            for num_conditional_tokens, cond_idx in enumerate(conditional_data):
                token_duration = get_duration_from_token(
                    inference_cfg.EVENT.event_representation, cond_idx,
                    tokens_list)
                if token_duration:
                    duration += token_duration
                if duration >= inference_cfg.INPUT.conditional_duration:
                    break
            print("* Total number of tokens used for condition is {} for"
                  " duration {}".format(num_conditional_tokens, duration))
        else:
            num_conditional_tokens = min(num_conditional_tokens,
                                         len(conditional_data))
            print("* Total number of tokens used for condition is {}".format(
                num_conditional_tokens))
        _write_tokens(os.path.join(out_dir, "prefix" + ext), tokens_list,
                      conditional_data[:num_conditional_tokens])
        _write_tokens(os.path.join(out_dir, "full" + ext), tokens_list,
                      conditional_data)
    primed = conditional_data is not None and num_conditional_tokens >= 1

    start_id = 1 if cfg.TRAIN.replace_start_with_pad else 0  # <PAD> / <S>

    def prime(seq, lanes):
        """Prime a fresh memory with the conditional prefix."""
        mems = xl.init_mems(xcfg, mem_len, lanes, device=device)
        if not primed:
            return seq, mems
        context = torch.tensor(
            seq + conditional_data[:num_conditional_tokens - 1],
            dtype=torch.long, device=device)[:, None].repeat(1, lanes)
        _, mems = prime_step(params, context, mems)
        return seq + conditional_data[:num_conditional_tokens], mems

    if (not inference_cfg.GENERATION.duration_based
            and not inference_cfg.MODEL.debug):
        # fixed length: independent files in waves of up to MAX_LANES lanes
        n_files = inference_cfg.INPUT.num_midi_files
        generation_length = inference_cfg.GENERATION.generation_length
        done = 0
        while done < n_files:
            lanes = min(MAX_LANES, n_files - done)
            seq_prefix, mems = prime([start_id], lanes)
            first = torch.full((lanes,), seq_prefix[-1], dtype=torch.long,
                               device=device)
            tokens, _ = generate(first, mems, generation_length)
            for lane in range(lanes):
                print("Generating the Midi File Number: "
                      + str(done + lane + 1))
                seq = seq_prefix + tokens[:, lane].tolist()
                out_fp = os.path.join(out_dir, str(done + lane) + ext)
                _write_tokens(out_fp, tokens_list, seq[1:])
                summary["files"].append(out_fp)
            done += lanes
        return summary

    for midi_file in range(inference_cfg.INPUT.num_midi_files):
        out_fp = os.path.join(out_dir, str(midi_file) + ext)
        print("Generating the Midi File Number: " + str(midi_file + 1))
        seq, mems = prime([start_id], 1)

        if inference_cfg.GENERATION.duration_based:
            # data-dependent stop: host loop over single decode steps
            duration = 0.0
            empty_run = torch.zeros((1,), dtype=torch.long, device=device)
            token = torch.tensor([seq[-1]], dtype=torch.long, device=device)
            for _ in range(inference_cfg.GENERATION.max_generation_length):
                token_duration = get_duration_from_token(
                    inference_cfg.EVENT.event_representation, seq[-1],
                    tokens_list)
                if token_duration:
                    duration += token_duration
                if duration >= inference_cfg.GENERATION.generation_duration:
                    break
                g = sampling.gumbel_noise((1, V), generator, device)
                token, mems, empty_run = decode_step(params, mems, token,
                                                     empty_run, g)
                seq.append(int(token[0]))
        else:
            first = torch.tensor([seq[-1]], dtype=torch.long, device=device)
            tokens, mems = generate(first, mems,
                                    inference_cfg.GENERATION.generation_length)
            seq.extend(tokens[:, 0].tolist())

        _write_tokens(out_fp, tokens_list, seq[1:])
        summary["files"].append(out_fp)

        if inference_cfg.MODEL.debug:
            _debug_check(params, xcfg, prime_step, mems, seq, mem_len, device)
            if primed:
                _prime_nll(params, xcfg, prime_step, conditional_data,
                           num_conditional_tokens, start_id, mem_len, device)
            with open(os.path.join(out_dir, "inference.yml"), "w") as f:
                f.write(str(inference_cfg))
    return summary


def _debug_check(params, xcfg, prime_step, mems, seq, mem_len, device):
    """Incremental memories (built token by token by the sampler) must equal
    the memories of one batch prime over the same sequence."""
    data = torch.tensor(seq[:-1], dtype=torch.long, device=device)[:, None]
    _, batch_mems = prime_step(params, data,
                               xl.init_mems(xcfg, mem_len, 1, device=device))
    batch_f32 = batch_mems.hids.float()
    if mems.hids.dtype == torch.bfloat16:
        # the paths agree to a few ulps at the activation scale: 6 bf16 ulps
        # of the largest magnitude, ulp(x) = 2^(floor(log2|x|) - 7)
        max_abs = float(batch_f32.abs().max())
        exp = math.floor(math.log2(max_abs)) if max_abs > 0 else 0
        atol = 6 * 2.0 ** (exp - 7)
    else:
        atol = 1e-2
    diff = float((mems.hids.float() - batch_f32).abs().max())
    if not diff < atol:
        raise AssertionError(
            f"incremental and batch memories diverged: {diff} >= {atol}")
    print(f"Mem same (max diff {diff:.6g}, tolerance {atol:.6g})")


def _prime_nll(params, xcfg, prime_step, conditional_data, n, start_id,
               mem_len, device):
    """NLL of the conditional prefix, one token at a time."""
    input_index = start_id
    nll = 0.0
    mems = xl.init_mems(xcfg, mem_len, 1, device=device)
    for i in range(n):
        target = conditional_data[i]
        inp = torch.tensor([[input_index]], dtype=torch.long, device=device)
        logits, mems = prime_step(params, inp, mems)
        logp = torch.log_softmax(logits[-1, 0].float(), dim=-1)
        nll += -float(logp[target])
        input_index = target
    print("Prime NLL: {}, Prime PPL: {}".format(nll / n, np.exp(nll / n)))


def parse_args():
    parser = argparse.ArgumentParser(description="Transformer-XL generation "
                                                 "(PyTorch port)")
    parser.add_argument("--inference_config", type=str,
                        default="inference_config/inference_unconditional.yml",
                        help="path to the cfg file")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                        "runs on the CPU)")
    return parser.parse_args()


if __name__ == "__main__":
    args = parse_args()
    inference_cfg = inference_config(args.inference_config)
    print(inference_cfg)
    main(inference_cfg, args.device)
