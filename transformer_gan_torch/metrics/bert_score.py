"""BERT pseudo-log-likelihood scorer for generated token files.

Counterpart of ``transformer_gan_tpu/metrics/bert_score.py`` (reference
metrics/bert_score.py): each token sequence is cut into 512-token blocks;
for each block, ``block_size`` copies with one position replaced by
[MASK] (the mask on the diagonal) go through the pretrained BERT MLM, and
the score is the mean log-probability of the true token at each masked
position. Sub-batches of rows bound the memory; their results stay on the
device until the block's mean.

    python -m transformer_gan_torch.metrics.bert_score \\
        --model_path BERT_CKPT_DIR --input_dir DIR_OF_NPY [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

BLOCK_SIZE = 512


def sent_encode(path, len_tokens_evaluated=2048, block_size=BLOCK_SIZE):
    """npy token file -> list of its full blocks."""
    tokens = np.load(path)[:len_tokens_evaluated].tolist()
    return [tokens[i:i + block_size]
            for i in range(0, len(tokens) - block_size + 1, block_size)]


def make_block_scorer(params, bert_cfg, mask_token_id: int,
                      sub_batch: int = 64):
    """block (a list of ids) -> mean log-probability of each position's
    token with that position masked (the parameters on their device)."""
    from ..models import bert as bert_mod
    device = params["word_embeddings"].device

    @torch.no_grad()
    def score_block(block):
        block = torch.as_tensor(np.asarray(block, np.int64), device=device)
        n = block.shape[0]
        outs = []
        for j in range(0, n, sub_batch):
            pos = torch.arange(j, min(j + sub_batch, n), device=device)
            rows = block.repeat(len(pos), 1)
            rows[torch.arange(len(pos), device=device), pos] = mask_token_id
            hidden = bert_mod.bert_encode(params, bert_cfg, input_ids=rows)
            logits = bert_mod.bert_mlm_logits(params, bert_cfg, hidden)
            logp = torch.log_softmax(logits.float(), dim=-1)
            outs.append(logp[torch.arange(len(pos), device=device), pos,
                             block[pos]])
        return float(torch.cat(outs).mean())

    return score_block


def run_score(model_path: str, input_dir: str,
              len_tokens_evaluated: int = 2048, device=None) -> float:
    """Mean pseudo-log-likelihood over the npy files of ``input_dir``.

    The BERT is sized by the checkpoint's metadata and takes every
    matching leaf of it; a missing checkpoint raises (random-init
    pseudo-likelihoods look plausible but mean nothing). ``device``: the
    card unless the caller passes "cpu"."""
    from .._native import resolve_device
    from ..train import checkpoint as ckpt

    if not (model_path and os.path.isdir(model_path)):
        raise FileNotFoundError(
            f"bert_score needs a pretrained BERT checkpoint; "
            f"{model_path!r} is not a checkpoint directory")
    cfg, params = ckpt.load_bert_model(model_path, resolve_device(device))
    mask_token_id = cfg.vocab_size - 1  # [MASK] appended last
    scorer = make_block_scorer(params, cfg, mask_token_id)

    scores = []
    for path in sorted(glob.glob(os.path.join(input_dir, "*.npy"))):
        blocks = sent_encode(path, len_tokens_evaluated)
        if not blocks:
            continue
        scores.append(float(np.mean([scorer(b) for b in blocks])))
        print(f"{os.path.basename(path)}: {scores[-1]:.4f}")
    mean = float(np.mean(scores)) if scores else float("nan")
    print(f"mean pseudo-log-likelihood over {len(scores)} files: {mean:.4f}")
    return mean


def main(argv=None) -> float:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True,
                        help="BERT MLM checkpoint directory")
    parser.add_argument("--input_dir", type=str, required=True,
                        help="directory of generated token .npy files")
    parser.add_argument("--len_tokens_evaluated", type=int, default=2048)
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the card)")
    args = parser.parse_args(argv)
    return run_score(args.model_path, args.input_dir,
                     args.len_tokens_evaluated, args.device)


if __name__ == "__main__":
    main()
