"""RelGAN CNN discriminator and the vanilla CNN classifier, as functions on
tensors.

Counterpart of ``transformer_gan_tpu/models/discriminator.py``
(``RelganConfig``, ``init_relgan_params``, ``relgan_logits``): a bias-free
linear "embedding" of one-hot or soft vocab distributions, multi-
representation Conv2d banks over (filter_size x emb_dim_single) windows with
stride emb_dim_single, max-pool over time, a highway layer and one logit per
representation. Parameters are a flat ``dict[str, Tensor]`` with the JAX
tree's names (``embeddings``, ``convs.0.w``, ...), initialised bit for bit
like the JAX package. Dropout draws from an explicit generator, or takes its
uniform draws as an input.

The vanilla CNN classifier (``CnnConfig``, ``init_cnn_params``,
``cnn_features``, ``cnn_logits``; the reference's CNNDiscriminator /
CNNClassifier over token ids) and the GRU discriminator (``GruConfig``,
``init_gru_params``, ``gru_logits``: two bidirectional GRU layers over the
token embeddings, the four final states through a tanh feature layer) are
kept, as in the JAX package, for the inventory: no GAN route reaches them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

DIS_FILTER_SIZES = (2, 3, 4, 5)
DIS_NUM_FILTERS = (300, 300, 300, 300)


@dataclasses.dataclass(frozen=True)
class RelganConfig:
    embed_dim: int = 64
    num_rep: int = 64
    vocab_size: int = 310
    dropout: float = 0.25
    init: str = "uniform"          # uniform | normal | truncated_normal
    filter_sizes: tuple = DIS_FILTER_SIZES
    num_filters: tuple = DIS_NUM_FILTERS
    compute_dtype: str = "float32"

    @property
    def emb_dim_single(self) -> int:
        return self.embed_dim // self.num_rep

    @property
    def feature_dim(self) -> int:
        return sum(self.num_filters)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def _init_array(rng, shape, init: str) -> np.ndarray:
    """Fan-in normal, U(-0.05, 0.05) or truncated normal (the JAX
    package's draws, in its order)."""
    stddev = 1.0 / np.sqrt(shape[0]) if len(shape) > 0 else 1.0
    if init == "uniform":
        return rng.uniform(-0.05, 0.05, size=shape)
    if init == "normal":
        return rng.normal(0.0, stddev, size=shape)
    if init == "truncated_normal":
        vals = rng.normal(0.0, stddev, size=shape + (4,))
        idx = (np.abs(vals) < 2 * stddev).argmax(axis=-1)
        return np.take_along_axis(vals, idx[..., None], axis=-1)[..., 0]
    raise ValueError(init)


def init_relgan_params(cfg: RelganConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    rng = np.random.RandomState(seed)

    def t(shape):
        a = np.asarray(_init_array(rng, shape, cfg.init), dtype=np.float32)
        return torch.from_numpy(a)

    params = {"embeddings": t((cfg.vocab_size, cfg.embed_dim)),
              "highway_w": t((cfg.feature_dim, cfg.feature_dim)),
              "highway_b": t((cfg.feature_dim,)),
              "feature2out_w": t((cfg.feature_dim, 100)),
              "feature2out_b": t((100,)),
              "out2logits_w": t((100, 1)),
              "out2logits_b": t((1,))}
    for i, (n, f) in enumerate(zip(cfg.num_filters, cfg.filter_sizes)):
        params[f"convs.{i}.w"] = t((n, 1, f, cfg.emb_dim_single))  # OIHW
        params[f"convs.{i}.b"] = t((n,))
    return params


def dropout_shape(cfg: RelganConfig, bsz: int) -> tuple[int, int]:
    """Shape of the features dropout acts on for ``bsz`` rows."""
    return (bsz * cfg.num_rep, cfg.feature_dim)


def relgan_logits(params, cfg: RelganConfig, inp: torch.Tensor, *,
                  train: bool = False, generator: torch.Generator | None = None,
                  dropout_u: torch.Tensor | None = None) -> torch.Tensor:
    """inp: [bsz, seq_len, vocab] one-hot / soft -> logits [bsz * num_rep].
    With ``train``, features are kept where a uniform draw (``dropout_u`` of
    :func:`dropout_shape`, else drawn from ``generator``) is below
    1 - dropout, and scaled by 1 / (1 - dropout)."""
    cd = cfg.cdtype
    emb = (inp.to(cd) @ params["embeddings"].to(cd))[:, None]  # NCHW
    pools = []
    for i in range(len(cfg.filter_sizes)):
        out = F.conv2d(emb, params[f"convs.{i}.w"].to(cd),
                       params[f"convs.{i}.b"].to(cd),
                       stride=(1, cfg.emb_dim_single))
        pools.append(torch.relu(out).amax(dim=2))        # [bsz, n, num_rep]
    pred = torch.cat(pools, dim=1).transpose(1, 2).reshape(-1, cfg.feature_dim)
    highway = pred @ params["highway_w"].to(cd) + params["highway_b"].to(cd)
    gate = torch.sigmoid(highway)
    pred = gate * torch.relu(highway) + (1.0 - gate) * pred
    if train and cfg.dropout > 0 and (dropout_u is not None
                                      or generator is not None):
        if dropout_u is None:
            dropout_u = torch.rand(pred.shape, generator=generator,
                                   device=pred.device)
        keep = dropout_u.to(pred.device) < 1.0 - cfg.dropout
        pred = torch.where(keep, pred / (1.0 - cfg.dropout), 0.0)
    pred = pred @ params["feature2out_w"].to(cd) + params["feature2out_b"].to(cd)
    logits = pred @ params["out2logits_w"].to(cd) + params["out2logits_b"].to(cd)
    return logits[:, 0]


# ---------------------------------------------------------------------------
# Vanilla CNN classifier over token ids
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CnnConfig:
    embed_dim: int = 64
    vocab_size: int = 310
    k_label: int = 2
    dropout: float = 0.2
    init: str = "uniform"
    filter_sizes: tuple = DIS_FILTER_SIZES
    num_filters: tuple = DIS_NUM_FILTERS
    padding_idx: int = 1

    @property
    def feature_dim(self) -> int:
        return sum(self.num_filters)


def init_cnn_params(cfg: CnnConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """The JAX package's draws in its order; the padding row of the
    embeddings zeroed (``nn.Embedding(padding_idx=...)``)."""
    rng = np.random.RandomState(seed)

    def t(shape):
        a = np.asarray(_init_array(rng, shape, cfg.init), dtype=np.float32)
        return torch.from_numpy(a)

    emb = t((cfg.vocab_size, cfg.embed_dim))
    emb[cfg.padding_idx] = 0.0
    params = {"embeddings": emb}
    for i, (n, f) in enumerate(zip(cfg.num_filters, cfg.filter_sizes)):
        params[f"convs.{i}.w"] = t((n, 1, f, cfg.embed_dim))      # OIHW
        params[f"convs.{i}.b"] = t((n,))
    params.update({"highway_w": t((cfg.feature_dim, cfg.feature_dim)),
                   "highway_b": t((cfg.feature_dim,)),
                   "feature2out_w": t((cfg.feature_dim, cfg.k_label)),
                   "feature2out_b": t((cfg.k_label,))})
    return params


def cnn_features(params, cfg: CnnConfig, input_ids: torch.Tensor
                 ) -> torch.Tensor:
    """[bsz, seq] ids -> features [bsz, feature_dim]: convolutions over the
    whole embedding width, max-pool over time, a highway layer."""
    emb = params["embeddings"][input_ids][:, None]         # [bsz, 1, seq, e]
    pools = []
    for i in range(len(cfg.filter_sizes)):
        out = F.conv2d(emb, params[f"convs.{i}.w"], params[f"convs.{i}.b"])
        pools.append(torch.relu(out)[..., 0].amax(dim=2))   # [bsz, n]
    pred = torch.cat(pools, dim=1)
    highway = pred @ params["highway_w"] + params["highway_b"]
    gate = torch.sigmoid(highway)
    return gate * torch.relu(highway) + (1.0 - gate) * pred


def cnn_logits(params, cfg: CnnConfig, input_ids: torch.Tensor, *,
               train: bool = False,
               dropout_u: torch.Tensor | None = None) -> torch.Tensor:
    """[bsz, k_label] logits; with ``train`` and ``dropout_u`` (uniform
    draws of the features' shape) dropout on the features."""
    feat = cnn_features(params, cfg, input_ids)
    if train and cfg.dropout > 0 and dropout_u is not None:
        keep = dropout_u.to(feat.device) < 1.0 - cfg.dropout
        feat = torch.where(keep, feat / (1.0 - cfg.dropout), 0.0)
    return feat @ params["feature2out_w"] + params["feature2out_b"]


# ---------------------------------------------------------------------------
# GRU discriminator over token ids
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GruConfig:
    embedding_dim: int = 64
    vocab_size: int = 310
    hidden_dim: int = 64
    feature_dim: int = 64
    padding_idx: int = 1
    dropout: float = 0.2


def init_gru_params(cfg: GruConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """The JAX package's U(-0.05, 0.05) draws in its order: the embeddings
    (padding row zeroed), then 2 layers x 2 directions of GRU cells
    (``layers.{2 layer + direction}``, torch ``nn.GRU``'s layout: w_ih [3h,
    in], w_hh [3h, h], gates r, z, n), then the feature and output layers."""
    rng = np.random.RandomState(seed)

    def t(shape):
        return torch.from_numpy(np.asarray(_init_array(rng, shape, "uniform"),
                                           dtype=np.float32))

    emb = t((cfg.vocab_size, cfg.embedding_dim))
    emb[cfg.padding_idx] = 0.0
    h, e = cfg.hidden_dim, cfg.embedding_dim
    params = {"embeddings": emb}
    for layer in range(2):
        in_dim = e if layer == 0 else 2 * h
        for direction in range(2):
            p = f"layers.{2 * layer + direction}."
            params.update({p + "w_ih": t((3 * h, in_dim)),
                           p + "b_ih": t((3 * h,)),
                           p + "w_hh": t((3 * h, h)),
                           p + "b_hh": t((3 * h,))})
    params.update({"gru2hidden_w": t((2 * 2 * h, cfg.feature_dim)),
                   "gru2hidden_b": t((cfg.feature_dim,)),
                   "feature2out_w": t((cfg.feature_dim, 2)),
                   "feature2out_b": t((2,))})
    return params


def _gru_direction(params, prefix: str, x: torch.Tensor, reverse: bool):
    """One GRU direction over x [seq, bsz, in] -> (outputs [seq, bsz, h],
    final state [bsz, h])."""
    w_ih, b_ih = params[prefix + "w_ih"], params[prefix + "b_ih"]
    w_hh, b_hh = params[prefix + "w_hh"], params[prefix + "b_hh"]
    gi_all = x @ w_ih.T + b_ih                 # the input gates at once
    h = x.new_zeros((x.shape[1], w_hh.shape[1]))
    outs = []
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    for t in steps:
        ir, iz, inn = gi_all[t].chunk(3, dim=-1)
        hr, hz, hn = (h @ w_hh.T + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        h = (1 - z) * n + z * h
        outs.append(h)
    if reverse:
        outs.reverse()
    return torch.stack(outs), h


def gru_logits(params, cfg: GruConfig, input_ids: torch.Tensor, *,
               train: bool = False,
               dropout_u: torch.Tensor | None = None) -> torch.Tensor:
    """[bsz, seq] ids -> [bsz, 2] logits; with ``train`` and ``dropout_u``
    (uniform draws of the features' shape) dropout on the features."""
    x = params["embeddings"][input_ids].transpose(0, 1)     # [seq, bsz, e]
    finals = []
    for layer in range(2):
        of, hf = _gru_direction(params, f"layers.{2 * layer}.", x, False)
        ob, hb = _gru_direction(params, f"layers.{2 * layer + 1}.", x, True)
        x = torch.cat([of, ob], dim=-1)
        finals += [hf, hb]
    feature = torch.tanh(torch.cat(finals, dim=-1) @ params["gru2hidden_w"]
                         + params["gru2hidden_b"])
    if train and cfg.dropout > 0 and dropout_u is not None:
        keep = dropout_u.to(feature.device) < 1.0 - cfg.dropout
        feature = torch.where(keep, feature / (1.0 - cfg.dropout), 0.0)
    return feature @ params["feature2out_w"] + params["feature2out_b"]
