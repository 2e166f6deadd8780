"""MLE convergence trajectories of the port (counterpart of the JAX
package's ``tools/convergence_parity.py``).

Trains the port's production MLE step (``train/step.make_mle_train_step``,
the fused optimizer and the inv_sqrt schedule of ``train/optim``, clip,
pad-masked micro-chunk losses, the XL memory carried across steps and
resets, dropout 0) from given initial weights on a recorded batch stream,
and evaluates it every ``eval_every`` steps with ``make_eval_step`` over
the validation pieces (memory reset at each new group of pieces). It
returns the train NLL of every step and the val NLL of every eval, so that
two runs from the same weights on the same stream can be held against each
other: the port against the JAX package on the CPU (the tests), the kernel
route against the plain route, and bf16 against fp32, on the card.

Widths: ``tiny`` is the JAX tool's operating point (2 layers, 4 heads,
d_model 64, d_inner 128, tgt 32, mem 32, B 8 in 2 micro-chunks);
``baseline`` the baseline model's widths (10 heads, d_model 500, d_inner
1000: d_head 50, as the attention kernels run it) at 2 layers, B 32, tgt
128, mem 256, on a larger corpus (B must stay below the piece count).

    python -m transformer_gan_torch.tools.convergence_parity --out RES.json \\
        [--device cpu] [--route kernel|plain] [--dtype float32|bfloat16] \\
        [--width tiny|baseline] [--optim adam|lamb] [--steps 150] \\
        [--eval_every 50]

It runs the K/V-cache layout (the production one; the JAX tool runs the
raw-hidden memory). Without ``--device`` it runs on the card, and raises
without one.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import convert
from .._native import resolve_device
from ..config import PACKAGED_VOCAB, training_config
from ..data.dataset import MusicDataset
from ..models import xl
from ..train import optim as topt
from ..train import step as tstep

N_TOKEN = 310
LR, WARMUP, CLIP, LR_MIN = 1e-3, 10, 0.25, 1e-6
INIT_SEED = 7       # the JAX tool's init_xl_params seed
WIDTHS = {
    "tiny": {"n_layer": 2, "n_head": 4, "d_model": 64, "d_inner": 128,
             "tgt": 32, "mem": 32, "bsz": 8, "batch_chunk": 2,
             "eval_bsz": 4, "eval_tgt": 32, "eval_mem": 32,
             "n_train": 30, "n_val": 8},
    "baseline": {"n_layer": 2, "n_head": 10, "d_model": 500, "d_inner": 1000,
                 "tgt": 128, "mem": 256, "bsz": 32, "batch_chunk": 2,
                 "eval_bsz": 4, "eval_tgt": 128, "eval_mem": 256,
                 "n_train": 256, "n_val": 16},
}


def make_corpus(seed=0, n_train=30, n_val=8):
    """Markov-structured token sequences (learnable, unlike uniform noise):
    next ~ current + {1,2,3} with occasional jumps, over ids [2, 310). The
    same ``RandomState`` draws as the JAX tool, so the same pieces."""
    rng = np.random.RandomState(seed)

    def piece(length):
        toks = [int(rng.randint(2, N_TOKEN))]
        for _ in range(length - 1):
            if rng.rand() < 0.05:
                toks.append(int(rng.randint(2, N_TOKEN)))
            else:
                step = rng.choice([1, 2, 3], p=[0.6, 0.3, 0.1])
                toks.append(2 + (toks[-1] - 2 + step) % (N_TOKEN - 2))
        return np.asarray(toks, np.int64)

    train = [piece(int(rng.randint(200, 600))) for _ in range(n_train)]
    val = [piece(int(rng.randint(200, 400))) for _ in range(n_val)]
    return train, val


def write_dataset(data_dir: str, train_pieces, val_pieces) -> None:
    """A data directory for ``MusicDataset``: the packaged vocab and one
    int32 ``.npy`` a piece in train / valid / test (the first two valid
    pieces)."""
    os.makedirs(data_dir, exist_ok=True)
    shutil.copyfile(PACKAGED_VOCAB, os.path.join(data_dir, "vocab.txt"))
    for split, pieces in [("train", train_pieces), ("valid", val_pieces),
                          ("test", val_pieces[:2])]:
        os.makedirs(os.path.join(data_dir, split))
        for i, p in enumerate(pieces):
            np.save(os.path.join(data_dir, split, f"p{i:03d}.npy"),
                    p.astype(np.int32))


def record_batches(train_pieces, val_pieces, n_steps, seed=1, width="tiny"):
    """The stream both runs consume, from the port's iterators:
    ``n_steps`` train batches (data, target, reset) and every validation
    window (data, target, reset_all, tokens, status). Returns (train
    batches, val batches, pad id)."""
    w = WIDTHS[width]
    with tempfile.TemporaryDirectory() as d:
        write_dataset(d, train_pieces, val_pieces)
        ds = MusicDataset(d, training_config())
    stream = ds.get_iterator(w["bsz"], w["tgt"], split="train",
                             do_shuffle=True, seed=seed)()
    train_batches = []
    for _ in range(n_steps):
        data, target, reset, _, _ = next(stream)
        train_batches.append((data.copy(), target.copy(), reset.copy()))
    val_batches = list(ds.eval_iterator(w["eval_bsz"], w["eval_tgt"],
                                        split="valid")())
    return train_batches, val_batches, ds.vocab.pad_id


def make_cfg(cache_kv: bool, width: str = "tiny", dtype: str = "float32"):
    """The training config of the operating point (the JAX tool's
    ``make_cfg`` runs the raw-hidden memory, ``cache_kv`` False)."""
    w = WIDTHS[width]
    return training_config().merge({
        "MODEL": {"num_layers": w["n_layer"], "num_heads": w["n_head"],
                  "units": w["d_model"], "inner_size": w["d_inner"],
                  "dropout": 0.0, "attention_dropout": 0.0},
        "TRAIN": {"tgt_length": w["tgt"], "mem_length": w["mem"],
                  "batch_size": w["bsz"], "batch_chunk": w["batch_chunk"],
                  "clip": CLIP},
        "TPU": {"compute_dtype": dtype, "cache_kv": bool(cache_kv)}})


def init_params(width: str = "tiny", seed: int = INIT_SEED) -> dict:
    """The initial weights as a JAX-style numpy tree (``init_xl_params`` at
    its defaults, bit for bit the JAX package's)."""
    xcfg = xl.XLConfig.from_cfg(make_cfg(True, width), N_TOKEN)
    return convert.params_to_jax(xl.init_xl_params(xcfg, seed=seed))


def run_port(train_batches, val_batches, pad_id, eval_every, init_params,
             optim="adam", *, device=None, dtype="float32", route="kernel",
             cache_kv: bool, width="tiny", lr=LR, warmup=WARMUP):
    """Train from ``init_params`` (a JAX-style numpy tree, through
    ``convert.params_from_jax``) on the recorded ``train_batches`` and
    evaluate every ``eval_every`` steps. ``route`` "kernel" lets each layer
    take the attention the production path picks (K1f / K1b on CUDA),
    "plain" forces the plain attention in the training and the eval steps.
    ``lr`` and ``warmup``: the base lr and the inv_sqrt schedule's warmup
    steps. Returns (train NLL a
    step, val NLL an eval), Python floats."""
    if route not in ("kernel", "plain"):
        raise ValueError(f"unknown route {route!r}")
    device = resolve_device(device)
    w = WIDTHS[width]
    bc = w["batch_chunk"]
    xcfg = xl.XLConfig.from_cfg(make_cfg(cache_kv, width, dtype), N_TOKEN)
    params = convert.params_from_jax(init_params)
    sched = topt.make_schedule("inv_sqrt", lr, len(train_batches), LR_MIN,
                               warmup)
    optimizer = topt.FusedOptimizer(optim, lr, sched, CLIP,
                                    layout=topt.FlatLayout.of(params))
    state = tstep.init_train_state(params, optimizer, xcfg, bc, w["mem"],
                                   w["bsz"] // bc, seed=0, device=device)
    attn = None if route == "kernel" else "plain"
    step_fn = tstep.make_mle_train_step(xcfg, optimizer, bc, pad_id,
                                        route=attn)
    eval_fn = tstep.make_eval_step(xcfg, pad_id, route=attn)

    def run_eval():
        tot, cnt = 0.0, 0
        mems = xl.init_mems(xcfg, w["eval_mem"], w["eval_bsz"], device=device)
        params = {k: v.detach() for k, v in state.params().items()}
        for data, target, reset_all, _, _ in val_batches:
            if reset_all:
                mems = tstep.reset_eval_mems(mems)
            s, c, mems = eval_fn(params, torch.from_numpy(data).to(device),
                                 torch.from_numpy(target).to(device), mems)
            tot += float(s)
            cnt += int(c)
        return tot / max(cnt, 1)

    train_nll, val_nll = [], []
    for data, target, reset in train_batches:
        batch = [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in
                 (tstep.chunk_batch(data, bc), tstep.chunk_batch(target, bc),
                  tstep.chunk_rows(reset, bc))]
        state, metrics = step_fn(state, *batch)
        train_nll.append(float(metrics["loss_weighted"])
                         / max(1, int(metrics["tokens"])))
        if len(train_nll) % eval_every == 0:
            val_nll.append(run_eval())
    return train_nll, val_nll


def max_gap(a, b) -> float:
    """The largest |a - b| over two trajectories of one length."""
    if len(a) != len(b):
        raise ValueError(f"trajectories of {len(a)} and {len(b)} points")
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--route", choices=("kernel", "plain"), default="kernel")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--width", choices=tuple(WIDTHS), default="tiny")
    ap.add_argument("--optim", choices=("adam", "lamb"), default="adam")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--eval_every", type=int, default=50)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    w = WIDTHS[args.width]
    train_pieces, val_pieces = make_corpus(0, w["n_train"], w["n_val"])
    train_b, val_b, pad_id = record_batches(train_pieces, val_pieces,
                                            args.steps, width=args.width)
    t0 = time.perf_counter()
    train_nll, val_nll = run_port(
        train_b, val_b, pad_id, args.eval_every, init_params(args.width),
        args.optim, device=args.device, dtype=args.dtype, route=args.route,
        cache_kv=True, width=args.width)
    res = {"steps": args.steps, "eval_every": args.eval_every,
           "optim": args.optim, "route": args.route, "dtype": args.dtype,
           "width": args.width, "seconds": time.perf_counter() - t0, "train_nll": train_nll,
           "val_nll": val_nll}
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"val NLL {val_nll} after {args.steps} steps "
          f"({res['seconds']:.1f} s)")
    return res


if __name__ == "__main__":
    main()
