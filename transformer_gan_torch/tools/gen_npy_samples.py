"""Dump generated token sequences as ``.npy`` files for
``metrics.bert_score`` (counterpart of the JAX package's
``tools/gen_npy_samples.py``, with the same flags plus ``--device``).

The samples come from a model directory (the training ``config.yml`` and
the port's ``<checkpoint>.pt``) through the quality metrics' sampler,
``infer/sample.generate_tokens_gumbel``: gumbel-argmax from <S> on a fresh
``seq_len``-slot memory, in waves of ``--wave`` lanes (K3's gumbel route on
the card, in sub-waves of at most 32 lanes; the rolling loop under
raw-hidden memory). Each file ``sample_{k:04d}.npy`` holds one piece of
``seq_len`` int32 ids, <S> first. The noise is drawn from one generator
seeded with ``--seed``; the temperature does not move the argmax.

    python -m transformer_gan_torch.tools.gen_npy_samples --model_dir RUN \\
        --out DIR [--checkpoint checkpoint_best] [--num 16] [--seq_len 2048] \\
        [--wave 4] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .._native import resolve_device
from ..config import training_config
from ..convert import PARAMS_SUFFIX, load_params
from ..infer.sample import generate_tokens_gumbel, gumbel_draws
from ..models import xl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--checkpoint", default="checkpoint_best")
    ap.add_argument("--out", required=True)
    ap.add_argument("--num", type=int, default=16)
    ap.add_argument("--seq_len", type=int, default=2048)
    ap.add_argument("--wave", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    args = ap.parse_args(argv)
    if args.num % args.wave:
        raise ValueError(f"--num {args.num} is not a multiple of --wave "
                         f"{args.wave}")
    device = resolve_device(args.device)
    cfg = training_config(os.path.join(args.model_dir, "config.yml"))
    params = load_params(os.path.join(args.model_dir,
                                      args.checkpoint + PARAMS_SUFFIX), device)
    xcfg = xl.XLConfig.from_cfg(cfg, params["word_emb"].shape[0])
    V = xcfg.n_token

    os.makedirs(args.out, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    waves = []
    for _ in range(args.num // args.wave):
        mems = xl.init_mems(xcfg, args.seq_len, args.wave, device=device)
        first = torch.zeros((args.wave,), dtype=torch.int64, device=device)
        g = gumbel_draws(args.seq_len - 1, args.wave, V, gen, device)
        waves.append(generate_tokens_gumbel(params, xcfg, args.seq_len, first,
                                            mems, g))
    k = 0
    for toks in waves:
        for col in toks.T.cpu().numpy():             # [wave, seq_len]
            np.save(os.path.join(args.out, f"sample_{k:04d}.npy"),
                    col.astype(np.int32))
            k += 1
    print(f"wrote {k} x {args.seq_len}-token samples to {args.out}")
    return k


if __name__ == "__main__":
    main()
