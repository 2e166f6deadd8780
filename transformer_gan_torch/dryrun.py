"""A data-parallel dry run (counterpart of ``__graft_entry__.py
dryrun_multichip``):

    python -m transformer_gan_torch.dryrun 2 [--device cpu]

starts N ranks in fresh processes (``parallel/mesh.spawn``): on the cards
one NCCL rank a card when there are N of them, else N gloo ranks sharing
the card (NCCL refuses two ranks on one device); with ``--device cpu`` N
gloo ranks on the CPU. They run, at tiny shapes in fp32, the full MLE step
with micro-chunks (lamb, lr / N), a few cnn GAN steps through the real
``Trainer`` (MLE step, dis and gen phases, the sharded eval) and one
spanbert dis and gen phase (the BERT critic under wgan-gp, its layer 0
frozen). Each rank checks what it can alone; the parent checks that the
ranks hold the same weights and prints one ``ok`` line per part.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from . import _native
from .parallel import mesh as pmesh

_GAN_CFG = {
    "MODEL": {"num_layers": 2, "num_heads": 2, "units": 16, "inner_size": 32},
    "TRAIN": {"batch_chunk": 2, "tgt_length": 16, "mem_length": 16,
              "max_step": 2, "log_interval": 1, "eval_interval": 2,
              "warmup_step": 1, "scheduler": "inv_sqrt"},
    "EVALUATE": {"tgt_length": 16, "mem_length": 16},
    "DISCRIMINATOR": {"type": "cnn", "start_iter": 0, "dis_loss_freq": 1,
                      "gen_loss_freq": 1, "dis_steps": 1,
                      "freeze_discriminator": False, "tgt_len": 16,
                      "mem_len": 16, "context_len": 3, "batch_chunk": 2,
                      "CNN": {"embed_dim": 16, "num_rep": 4,
                              "loss_type": "rsgan"}},
    "TPU": {"compute_dtype": "float32"},
}
_SPANBERT = {"DISCRIMINATOR": {"type": "bert", "BERT": {
    "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
    "intermediate_size": 64, "loss_type": "wgan-gp", "random_weights": True,
    "freeze_layers": ["0"]}}}


def _write_corpus(data_dir: str, n: int, seed: int = 11) -> None:
    from .config import PACKAGED_VOCAB
    from .data.vocab import BaseVocab
    rng = np.random.RandomState(seed)
    vocab = BaseVocab.from_file(PACKAGED_VOCAB)
    with open(os.path.join(data_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab.all_tokens) + "\n")
    for split in ("train", "valid", "test"):
        os.makedirs(os.path.join(data_dir, split))
        for i in range(max(24, 3 * n) if split == "train" else n + 2):
            np.save(os.path.join(data_dir, split, f"p{i:03d}.npy"),
                    rng.randint(2, 310, rng.randint(80, 300)).astype(np.int32))


def _mle_step() -> dict:
    from .models import xl
    from .parallel import sharding as psh
    from .train import optim as topt
    from .train import step as tstep
    n, dev = pmesh.current().world, pmesh.current().device
    xcfg = xl.XLConfig(n_layer=2, n_head=4, d_model=32, d_inner=64,
                       n_token=310, dropout=0.1, dropatt=0.1)
    params = xl.init_xl_params(xcfg, seed=0)
    batch_chunk, tgt, mem = 2, 8, 16
    bsz = 2 * n * batch_chunk           # 2 rows a rank a micro-batch
    opt = topt.FusedOptimizer(
        "lamb", 4e-3 / n, topt.make_schedule("inv_sqrt", 4e-3, 1000, 1e-4,
                                             10), 1.0,
        layout=topt.FlatLayout.of(params))
    state = tstep.init_train_state(params, opt, xcfg, batch_chunk, mem,
                                   bsz // batch_chunk // n, 0, dev)
    step = tstep.make_mle_train_step(xcfg, opt, batch_chunk, pad_id=1)
    rng = np.random.RandomState(0)
    data, target = (psh.batch_rows(rng.randint(0, 310, (tgt, bsz)),
                                   batch_chunk) for _ in range(2))
    state, met = step(state, *(torch.from_numpy(tstep.chunk_batch(
        x, batch_chunk)).to(dev) for x in (data, target)),
                      torch.zeros(batch_chunk, bsz // batch_chunk // n,
                                  dtype=torch.bool, device=dev))
    loss_w, tokens = pmesh.host_allreduce_sum(
        [float(met["loss_weighted"]), float(met["tokens"])])
    loss = loss_w / max(tokens, 1.0)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    return {"loss": loss, "tokens": int(tokens),
            "flat": state.flat.detach().cpu()}


def _gan_steps(data_dir: str) -> dict:
    from .config import training_config
    from .train.loop import Trainer
    n, dev = pmesh.current().world, pmesh.current().device
    cfg = training_config().merge(_GAN_CFG).merge(
        {"TRAIN": {"batch_size": 2 * n}, "EVALUATE": {"batch_size": n}})
    with tempfile.TemporaryDirectory() as work:
        tr = Trainer(cfg, data_dir, work, debug=True, device=dev)
        tr.train()
        dis0 = tr.gan.dis_flat.clone()
        tr.gan.dis_phase(tr.train_step_num)
        tr.gan.gen_phase(tr.train_step_num)
        gen_loss, dis_loss = tr.gan.pop_log_stats()
        out = {"gen_loss": gen_loss, "dis_loss": dis_loss,
               "dis_moved": not torch.equal(dis0, tr.gan.dis_flat),
               "flat": tr.state.flat.detach().cpu(),
               "dis_flat": tr.gan.dis_flat.cpu(), "steps": tr.train_step_num}
    cfg.merge(_SPANBERT)
    with tempfile.TemporaryDirectory() as work:
        tr = Trainer(cfg, data_dir, work, debug=True, device=dev)
        ph = tr.gan
        p0 = {k: v.clone() for k, v in ph.dis_params().items()}
        ph.dis_phase(1)
        ph.gen_phase(1)
        g, d = ph.pop_log_stats()
        after = ph.dis_params()
        out["spanbert"] = {
            "gen_loss": g, "dis_loss": d,
            "layer0_pinned": all(torch.equal(after[k], p0[k]) for k in p0
                                 if k.startswith("layers.0.")),
            "layer1_moved": any(not torch.equal(after[k], p0[k]) for k in p0
                                if k.startswith("layers.1.")),
            "dis_flat": ph.dis_flat.cpu()}
    return out


def _rank(mesh: pmesh.Mesh, data_dir: str) -> dict:
    return {"mle": _mle_step(), "gan": _gan_steps(data_dir)}


def dryrun_multichip(n: int, device=None) -> list:
    """Run the dry run on ``n`` ranks on the cards (the default; raises
    without one) or, with ``device`` ``"cpu"``, on the CPU; raises on any
    failure. Returns the ranks' results."""
    dev = _native.resolve_device(device)
    if dev.type == "cpu":
        where = dict(device="cpu", backend="gloo")
    elif dev.index is None and torch.cuda.device_count() >= n:
        where = dict(device="cuda", backend="nccl")         # a card a rank
    else:                                   # n ranks sharing one card
        where = dict(device=f"cuda:{dev.index or 0}", backend="gloo")
    if dev.type == "cuda":
        _native.build()                     # once, before the ranks start
    with tempfile.TemporaryDirectory() as data_dir:
        _write_corpus(data_dir, n)
        ranks = pmesh.spawn(_rank, n, data_dir, **where)
    mle, gan = ranks[0]["mle"], ranks[0]["gan"]
    for r in ranks[1:]:
        for a, b, what in ((r["mle"]["flat"], mle["flat"], "MLE weights"),
                           (r["gan"]["flat"], gan["flat"], "GAN generator"),
                           (r["gan"]["dis_flat"], gan["dis_flat"],
                            "discriminator"),
                           (r["gan"]["spanbert"]["dis_flat"],
                            gan["spanbert"]["dis_flat"], "BERT critic")):
            if not torch.equal(a, b):
                raise AssertionError(f"the ranks' {what} differ")
    print(f"dryrun_multichip({n}): ok ({n} {where['backend']} ranks on "
          f"{where['device']}), loss={mle['loss']:.4f}, "
          f"tokens={mle['tokens']}")
    if not (gan["dis_moved"] and gan["gen_loss"] != 0.0
            and gan["dis_loss"] != 0.0
            and np.isfinite([gan["gen_loss"], gan["dis_loss"]]).all()):
        raise AssertionError(f"cnn GAN phases: {gan}")
    print(f"dryrun_multichip({n}): gan ok (cnn/rsgan dis+gen phases on "
          f"{n} ranks, dis params moved, gen_loss={gan['gen_loss']:.4f}, "
          f"dis_loss={gan['dis_loss']:.4f})")
    sp = gan["spanbert"]
    if not (sp["layer0_pinned"] and sp["layer1_moved"] and sp["gen_loss"]
            != 0.0 and sp["dis_loss"] != 0.0
            and np.isfinite([sp["gen_loss"], sp["dis_loss"]]).all()):
        raise AssertionError(f"spanbert GAN phases: {sp}")
    print(f"dryrun_multichip({n}): spanbert ok (BERT-D wgan-gp dis+gen "
          f"phases on {n} ranks, layer-0 frozen, "
          f"gen_loss={sp['gen_loss']:.4f}, dis_loss={sp['dis_loss']:.4f})")
    return ranks


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n", type=int, nargs="?", default=2,
                        help="number of ranks")
    parser.add_argument("--device", default=None,
                        help="cpu for gloo ranks on the CPU (default: the "
                        "cards)")
    args = parser.parse_args(argv)
    return dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
