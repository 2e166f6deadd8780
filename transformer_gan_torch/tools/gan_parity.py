"""GAN training trajectories of the port (counterpart of the JAX package's
``tools/gan_parity.py``).

Runs N dis + gen phase pairs of the production ``train/gan_loop.GanPhases``
(built by ``train/loop.Trainer``; cnn / rsgan, every dropout 0, the RelGAN's
included) from given generator and discriminator weights, on recorded real
batches (two per phase pair: one for the dis phase, one for the gen phase)
and recorded random numbers: the phases' ``_draws`` hook hands out one
``models/gan.Draws`` per micro-batch from a list. ``recorded_draws`` makes
that list from per-phase uniforms (``models/gan.RecordedDraws``), as the
JAX tool injects them into its rolling sampler; any other ``Draws`` works
too (the tests recompute the JAX keys' draws for the cached layout, which
JAX cannot inject). It returns the logged dis and gen loss of every phase
and the final weights, so that two runs can be held against each other: the
port against the JAX package on the CPU (the tests), the kernel route (K4 /
K5 samplers, K6 / K7 reverse chains) against the plain route, and bf16
against fp32, on the card.

Widths: ``tiny`` is the JAX tool's operating point (2 layers, 2 heads,
d_model 32, d_inner 64, dis tgt 16, mem 16, context 3, batch_chunk 2,
sample_chunks_mem 2, B 4); ``cnn`` the cnn config's widths (10 heads,
d_model 500, d_inner 1000) at 2 layers, tgt 64, mem 64, context 5, B 16 in
one micro-batch and one sampled chunk.

    python -m transformer_gan_torch.tools.gan_parity --out RES.json \\
        [--device cpu] [--route kernel|plain] [--dtype float32|bfloat16] \\
        [--width tiny|cnn] [--phases 6]

It runs the K/V-cache layout with full backprop through the sample chain
(the production path; the JAX tool runs the rolling sampler). Without
``--device`` it runs on the card, and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

from .._native import resolve_device
from ..config import training_config
from ..data.dataset import MusicDataset
from ..models import discriminator as disc_mod
from ..models import gan as gan_mod
from ..models import xl
from .convergence_parity import make_corpus, write_dataset

N_TOKEN = 310
GEN_LR, DIS_LR = 1e-3, 1e-3
GEN_F, DIS_F = 2.0, 1.0
CLIP = 0.25
EMB_DIM, NUM_REP = 64, 64
WIDTHS = {
    "tiny": {"n_layer": 2, "n_head": 2, "d_model": 32, "d_inner": 64,
             "tgt": 16, "mem": 16, "context": 3, "sample_chunks": 2,
             "batch_chunk": 2, "bsz": 4, "n_train": 24, "n_val": 4},
    "cnn": {"n_layer": 2, "n_head": 10, "d_model": 500, "d_inner": 1000,
            "tgt": 64, "mem": 64, "context": 5, "sample_chunks": 1,
            "batch_chunk": 1, "bsz": 16, "n_train": 64, "n_val": 4},
}


def make_cfg(truncate_backprop: bool, cache_kv: bool, width: str = "tiny",
             dtype: str = "float32", gen_lr: float = GEN_LR,
             dis_lr: float = DIS_LR):
    """The training config of the operating point (the JAX tool's
    ``make_cfg``, which runs the raw-hidden memory, ``cache_kv`` False):
    dis and gen phases every step from step 0, one dis update a phase,
    constant schedules without warmup."""
    w = WIDTHS[width]
    return training_config().merge({
        "MODEL": {"num_layers": w["n_layer"], "num_heads": w["n_head"],
                  "units": w["d_model"], "inner_size": w["d_inner"],
                  "dropout": 0.0, "attention_dropout": 0.0},
        "TRAIN": {"batch_size": w["bsz"], "batch_chunk": 1,
                  "tgt_length": w["tgt"], "mem_length": w["mem"],
                  "clip": CLIP},
        "EVALUATE": {"batch_size": 2, "tgt_length": w["tgt"],
                     "mem_length": w["mem"]},
        "DISCRIMINATOR": {
            "type": "cnn", "start_iter": 0, "dis_loss_freq": 1,
            "gen_loss_freq": 1, "dis_steps": 1,
            "freeze_discriminator": False, "tgt_len": w["tgt"],
            "mem_len": w["mem"], "context_len": w["context"],
            "sample_chunks_mem": w["sample_chunks"],
            "batch_chunk": w["batch_chunk"],
            "truncate_backprop": bool(truncate_backprop),
            "backprop_outside": False, "gen_loss_factor": GEN_F,
            "dis_loss_factor": DIS_F, "gen_lr": gen_lr,
            "gen_scheduler": "constant", "gen_warmup_step": 0,
            "dis_scheduler": "constant", "dis_warmup_step": 0,
            "CNN": {"learning_rate": dis_lr, "embed_dim": EMB_DIM,
                    "num_rep": NUM_REP, "init": "uniform",
                    "loss_type": "rsgan"}},
        "TPU": {"compute_dtype": dtype, "cache_kv": bool(cache_kv)}})


def n_gen_steps(width: str = "tiny") -> int:
    """Gumbel draws a micro-batch: every token after the context."""
    return WIDTHS[width]["tgt"] - WIDTHS[width]["context"]


def make_data(n_phases: int, data_dir: str, seed: int = 0,
              width: str = "tiny"):
    """Write the corpus (``convergence_parity.make_corpus``) into
    ``data_dir`` and record ``2 n_phases`` real dis batches (the port's dis
    iterator, seed ``seed + 1``) and per phase the uniforms of the dis and
    of the gen phase, each [batch_chunk, n_steps, bsz / batch_chunk, V]
    from ``RandomState(seed + 2)``: the JAX tool's ``make_data``. Returns
    (recorded batches, uniforms)."""
    w = WIDTHS[width]
    train_pieces, val_pieces = make_corpus(seed, n_train=w["n_train"],
                                           n_val=w["n_val"])
    write_dataset(data_dir, train_pieces, val_pieces)
    ds = MusicDataset(data_dir, training_config())
    stream = ds.get_dis_iterator(w["bsz"], w["tgt"], split="train",
                                 do_shuffle=True, seed=seed + 1)()
    recorded = [next(stream)[0].copy() for _ in range(2 * n_phases)]
    rs = np.random.RandomState(seed + 2)
    shape = (w["batch_chunk"], n_gen_steps(width),
             w["bsz"] // w["batch_chunk"], N_TOKEN)
    noises = [(rs.uniform(size=shape).astype(np.float32),
               rs.uniform(size=shape).astype(np.float32))
              for _ in range(n_phases)]
    return recorded, noises


def recorded_draws(noises, device=None) -> list:
    """One ``RecordedDraws`` a micro-batch in the order the phases consume
    them: per phase pair the dis phase's micro-batches, then the gen
    phase's."""
    return [gan_mod.RecordedDraws(u[c], device)
            for dn, gn in noises for u in (dn, gn) for c in range(len(u))]


def flat_tree(tree, prefix: str = "") -> dict:
    """A JAX-style tree of dicts and lists (or a flat dict) as the port's
    dotted names -> numpy arrays."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat_tree(v, f"{prefix}{k}."))
    return out


def init_weights(cfg) -> tuple[dict, dict]:
    """The generator's and the discriminator's initial weights the trainer
    draws for ``cfg`` (``init_xl_params`` at TRAIN.seed, the RelGAN at seed
    17; both bit for bit the JAX package's), as flat numpy dicts."""
    xcfg = xl.XLConfig.from_cfg(cfg, N_TOKEN)
    gen = xl.init_xl_params(xcfg, seed=cfg.TRAIN.seed,
                            base_init=tuple(cfg.INITIALIZER.base_init),
                            embed_init=tuple(cfg.INITIALIZER.embed_init))
    d = cfg.DISCRIMINATOR.CNN
    dis = disc_mod.init_relgan_params(disc_mod.RelganConfig(
        embed_dim=d.embed_dim, num_rep=d.num_rep, vocab_size=N_TOKEN,
        init=d.init), seed=17)
    return ({k: v.numpy() for k, v in gen.items()},
            {k: v.numpy() for k, v in dis.items()})


def run_port(cfg, data_dir, recorded, draws, gen_init, dis_init, *,
             device=None, route="kernel"):
    """``len(recorded) // 2`` dis + gen phase pairs of the trainer's
    ``GanPhases`` from ``gen_init`` / ``dis_init`` (JAX-style trees or flat
    dicts of numpy arrays), the RelGAN's dropout 0, the dis batches from
    ``recorded`` and the micro-batches' random numbers from ``draws`` (in
    order). ``route``: "kernel" (the sampler and chain kernels on CUDA) or
    "plain". Returns (dis losses, gen losses, generator and discriminator
    weights after the run as flat numpy dicts)."""
    from ..train.loop import Trainer
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(cfg, data_dir=data_dir, work_dir=wd, debug=True,
                          device=device)
        gan = trainer.gan
        gan.dis_cfg = dataclasses.replace(gan.dis_cfg, dropout=0.0)
        gan.gcfg = dataclasses.replace(gan.gcfg, route=route)
        gan._dis_stream = iter([(b, None) for b in recorded])
        stream = iter(draws)
        gan._draws = lambda: next(stream)
        state = trainer.state
        with torch.no_grad():
            for flat, layout, init in ((state.flat, state.layout, gen_init),
                                       (gan.dis_flat, gan.dis_layout,
                                        dis_init)):
                flat.copy_(layout.flatten({
                    k: torch.tensor(v) for k, v in
                    flat_tree(init).items()}).to(device))
        dis_losses, gen_losses = [], []
        for k in range(len(recorded) // 2):
            d0 = gan.log_dis_loss
            gan.dis_phase(k + 1)
            dis_losses.append(float(gan.log_dis_loss - d0))
            g0 = gan.log_gen_loss
            gan.gen_phase(k + 1)
            gen_losses.append(float(gan.log_gen_loss - g0))
        gen_final = {k: v.detach().cpu().numpy()
                     for k, v in state.params().items()}
        dis_final = {k: v.detach().cpu().numpy()
                     for k, v in gan.dis_params().items()}
    return dis_losses, gen_losses, gen_final, dis_final


def _max_drift(a, b) -> float:
    """The largest |a - b| over every weight of two trees."""
    fa, fb = flat_tree(a), flat_tree(b)
    if fa.keys() != fb.keys():
        raise ValueError(f"trees differ: {sorted(fa.keys() ^ fb.keys())}")
    return max(float(np.abs(fa[k] - fb[k]).max()) for k in fa)


def drift_share(a, b, limit: float) -> float:
    """The share of the weights of two trees that differ by more than
    ``limit``."""
    fa, fb = flat_tree(a), flat_tree(b)
    beyond = sum(int((np.abs(fa[k] - fb[k]) > limit).sum()) for k in fa)
    return beyond / sum(v.size for v in fa.values())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--route", choices=("kernel", "plain"), default="kernel")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--width", choices=tuple(WIDTHS), default="tiny")
    ap.add_argument("--phases", type=int, default=6)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = make_cfg(False, True, args.width, args.dtype)
    with tempfile.TemporaryDirectory() as data_dir:
        recorded, noises = make_data(args.phases, data_dir, width=args.width)
        gen_init, dis_init = init_weights(cfg)
        t0 = time.perf_counter()
        dis, gen, _, _ = run_port(cfg, data_dir, recorded,
                                  recorded_draws(noises, device), gen_init,
                                  dis_init, device=device, route=args.route)
    res = {"phases": args.phases, "route": args.route, "dtype": args.dtype,
           "width": args.width, "seconds": time.perf_counter() - t0, "dis_loss": dis,
           "gen_loss": gen}
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"dis losses {dis}\ngen losses {gen}")
    return res


if __name__ == "__main__":
    main()
