"""What every driver shares: the program's configuration from the cell, the
seeded corpus, the program's ``Trainer`` with the benchmark's weights, and
the context the per-layer readers take."""
from __future__ import annotations

import dataclasses
import os
import types

import torch

from ..corpus import write_corpus
from ..reference import xl as ref_xl

@dataclasses.dataclass
class Dims:
    L: int
    d: int
    H: int
    dh: int
    di: int
    V: int

    def shapes(self) -> dict:
        return ref_xl.leaf_shapes(self.L, self.d, self.H, self.dh, self.di,
                                  self.V)


def program_config(cell: dict, overrides: dict):
    """The program's training configuration: the configuration file's values
    (its own ``TRAIN.seed`` too, which orders the data and draws dropout, so
    that every run does the same work), one card's rows, then
    ``overrides``."""
    from transformer_gan_torch.config import training_config
    conf = cell["config_data"]
    cfg = training_config().merge(conf["program_config"])
    cfg.TRAIN.batch_size = int(conf["deployment"]["rows_per_card"]) * int(
        cell["chips"])
    cfg.TPU.profile_dir = ""
    return cfg.merge(overrides)


def dims_of(cfg, vocab_size: int) -> Dims:
    m = cfg.MODEL
    return Dims(L=m.num_layers, d=m.units, H=m.num_heads,
                dh=m.units // m.num_heads, di=m.inner_size, V=vocab_size)


def build_trainer(cell: dict, seed: int, device, tmp: str, overrides: dict):
    """(trainer, cfg, dims, weights): the program's ``Trainer`` on a corpus
    written from ``seed``, its generator's weights replaced by ``weights``,
    made on the device from ``seed``. ``overrides`` merges into the
    configuration; the traffic's ``corpus`` key, then that of
    ``overrides``, into the corpus's sizes."""
    from transformer_gan_torch.train.loop import Trainer
    from transformer_gan_torch.parallel import sharding

    overrides = dict(overrides)
    corpus = {**cell["config_data"]["assumed"]["corpus"],
              **cell["traffic_data"].get("corpus", {}),
              **overrides.pop("corpus", {})}
    cfg = program_config(cell, overrides)
    with open(os.path.join(os.path.dirname(__file__), "..", "configs",
                           cell["config"] + ".vocab.txt")) as f:
        vocab = f.read().split()
    data_dir = os.path.join(tmp, "data")
    write_corpus(data_dir, vocab, seed, corpus)
    trainer = Trainer(cfg, data_dir, os.path.join(tmp, "work"),
                      device=str(device))
    dims = dims_of(cfg, len(vocab))
    weights = ref_xl.make_weights(dims.shapes(), seed, device)
    state = trainer.state
    if set(state.layout.names) != set(weights):
        raise RuntimeError("the program's leaves differ from the "
                           "configuration's: "
                           f"{sorted(set(state.layout.names) ^ set(weights))}")
    with torch.no_grad():
        state.flat.copy_(state.layout.flatten(weights))
    sharding.broadcast_state(state.flat)
    return trainer, cfg, dims, weights


def leaves(layout, flat: torch.Tensor) -> dict:
    """The program's flat vector under the leaf names, copied."""
    return {n: t.detach().clone() for n, t in layout.unflatten(flat).items()}


def launches() -> dict:
    from transformer_gan_torch import _native
    return dict(_native.LAUNCHES)


def context(**kw) -> types.SimpleNamespace:
    """What a metric's reader takes: ``trace`` (``portbench.trace.Trace``,
    or None untraced), ``window_s``, ``chips``, the window's ``launches``
    by kernel wrapper, ``flops`` of the model's work and ``tokens`` in the
    window, and the driver's own keys (shapes, spans, chunks)."""
    return types.SimpleNamespace(**kw)
