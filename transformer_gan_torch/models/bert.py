"""BERT encoder with MLM and sequence-classification heads, as functions on
tensors.

Counterpart of ``transformer_gan_tpu/models/bert.py``: the HF default
architecture (post-LN blocks, LayerNorm eps 1e-12, erf GELU, learned
position and token-type embeddings), an MLM head whose decoder is tied to
the word embeddings, and a pooler + classifier head whose class-0 logit is
the GAN critic's score. ``inputs_embeds`` is an input of its own because the
GAN scores soft one-hots times the embedding matrix.

Parameters are a flat ``dict[str, Tensor]`` with the JAX tree's names
(``word_embeddings``, ``layers.3.q_w``, ...), initialised bit for bit like
the JAX package. The attention is plain torch ops (matmul, softmax in fp32,
dropout on the probabilities): the wgan-gp penalty differentiates the critic
twice, and the probabilities' dropout draws are inputs.

Dropout (embeddings, attention probabilities, both residual branches, in
the JAX package's places) keeps an element where a uniform draw is below
1 - rate and scales it by 1 / (1 - rate). ``dropout_u(shape)`` returns the
draws of one site, called in site order: the embeddings, then per layer
the probabilities, the attention output and the feed-forward output.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .attention import layer_norm

BERT_LN_EPS = 1e-12  # HF BertConfig default layer_norm_eps

DropoutDraws = Callable[[tuple], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 311          # 310 + [MASK]
    hidden_size: int = 768
    num_hidden_layers: int = 5
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    num_labels: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    compute_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def init_bert_params(cfg: BertConfig, seed: int = 0,
                     init_std: float = 0.02) -> dict[str, torch.Tensor]:
    """HF-style init: normal(0, 0.02) weights, zero biases, LayerNorm (1, 0),
    drawn from ``np.random.RandomState(seed)`` in the JAX package's order."""
    rng = np.random.RandomState(seed)

    def normal(shape):
        return torch.from_numpy(np.asarray(rng.normal(0.0, init_std,
                                                      size=shape), np.float32))

    h, i = cfg.hidden_size, cfg.intermediate_size
    params = {
        "word_embeddings": normal((cfg.vocab_size, h)),
        "position_embeddings": normal((cfg.max_position_embeddings, h)),
        "token_type_embeddings": normal((cfg.type_vocab_size, h)),
        "emb_ln_scale": torch.ones(h), "emb_ln_bias": torch.zeros(h),
        "pooler_w": normal((h, h)), "pooler_b": torch.zeros(h),
        "classifier_w": normal((h, cfg.num_labels)),
        "classifier_b": torch.zeros(cfg.num_labels),
        # MLM head: transform + LN; decoder tied to word_embeddings
        "mlm_dense_w": normal((h, h)), "mlm_dense_b": torch.zeros(h),
        "mlm_ln_scale": torch.ones(h), "mlm_ln_bias": torch.zeros(h),
        "mlm_bias": torch.zeros(cfg.vocab_size),
    }
    for li in range(cfg.num_hidden_layers):
        p = f"layers.{li}."
        params.update({
            p + "q_w": normal((h, h)), p + "q_b": torch.zeros(h),
            p + "k_w": normal((h, h)), p + "k_b": torch.zeros(h),
            p + "v_w": normal((h, h)), p + "v_b": torch.zeros(h),
            p + "attn_out_w": normal((h, h)), p + "attn_out_b": torch.zeros(h),
            p + "attn_ln_scale": torch.ones(h),
            p + "attn_ln_bias": torch.zeros(h),
            p + "ffn_w1": normal((h, i)), p + "ffn_b1": torch.zeros(i),
            p + "ffn_w2": normal((i, h)), p + "ffn_b2": torch.zeros(h),
            p + "ffn_ln_scale": torch.ones(h),
            p + "ffn_ln_bias": torch.zeros(h),
        })
    return params


def _dropout(x: torch.Tensor, rate: float, dropout_u: DropoutDraws | None
             ) -> torch.Tensor:
    if dropout_u is None or rate <= 0.0:
        return x
    keep = dropout_u(tuple(x.shape)).to(x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _linear(x, params, w: str, b: str, cd):
    return x @ params[w].to(cd) + params[b].to(cd)


def bert_encode(params, cfg: BertConfig, input_ids=None, inputs_embeds=None,
                attention_mask=None, *, train: bool = False,
                dropout_u: DropoutDraws | None = None) -> torch.Tensor:
    """Embeddings and encoder: hidden states [bsz, seq, hidden] in the
    compute dtype. attention_mask: [bsz, seq], 1 attends, 0 is masked (the
    HF convention). Dropout runs with ``train`` and ``dropout_u``."""
    cd = cfg.cdtype
    if inputs_embeds is None:
        inputs_embeds = params["word_embeddings"].to(cd)[input_ids]
    else:
        inputs_embeds = inputs_embeds.to(cd)
    bsz, seq = inputs_embeds.shape[0], inputs_embeds.shape[1]
    draws = dropout_u if train else None

    pos = params["position_embeddings"].to(cd)[None, :seq]
    tok_type = params["token_type_embeddings"].to(cd)[0][None, None, :]
    x = layer_norm(inputs_embeds + pos + tok_type, params["emb_ln_scale"],
                   params["emb_ln_bias"], eps=BERT_LN_EPS)
    x = _dropout(x, cfg.hidden_dropout, draws)

    bias = None
    if attention_mask is not None:
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           -1e30).to(torch.float32)

    nh, hd = cfg.num_attention_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    for li in range(cfg.num_hidden_layers):
        p = f"layers.{li}."

        def heads(t):
            return t.reshape(bsz, seq, nh, hd).transpose(1, 2)

        q = heads(_linear(x, params, p + "q_w", p + "q_b", cd))
        k = heads(_linear(x, params, p + "k_w", p + "k_b", cd))
        v = heads(_linear(x, params, p + "v_w", p + "v_b", cd))
        scores = (q @ k.transpose(2, 3)).float() * scale
        if bias is not None:
            scores = scores + bias
        probs = _dropout(torch.softmax(scores, dim=-1), cfg.attention_dropout,
                         draws)
        ctx = (probs.to(cd) @ v).transpose(1, 2).reshape(bsz, seq, nh * hd)
        attn_out = _dropout(_linear(ctx, params, p + "attn_out_w",
                                    p + "attn_out_b", cd),
                            cfg.hidden_dropout, draws)
        x = layer_norm(x + attn_out, params[p + "attn_ln_scale"],
                       params[p + "attn_ln_bias"], eps=BERT_LN_EPS)
        hmid = F.gelu(_linear(x, params, p + "ffn_w1", p + "ffn_b1", cd),
                      approximate="none")
        ffn_out = _dropout(_linear(hmid, params, p + "ffn_w2", p + "ffn_b2",
                                   cd), cfg.hidden_dropout, draws)
        x = layer_norm(x + ffn_out, params[p + "ffn_ln_scale"],
                       params[p + "ffn_ln_bias"], eps=BERT_LN_EPS)
    return x


def bert_mlm_logits(params, cfg: BertConfig, hidden) -> torch.Tensor:
    """MLM head: transform, LayerNorm, tied decoder plus bias."""
    cd = cfg.cdtype
    h = F.gelu(_linear(hidden, params, "mlm_dense_w", "mlm_dense_b", cd),
               approximate="none")
    h = layer_norm(h, params["mlm_ln_scale"], params["mlm_ln_bias"],
                   eps=BERT_LN_EPS)
    return h @ params["word_embeddings"].to(cd).T + params["mlm_bias"].to(cd)


def bert_cls_logits(params, cfg: BertConfig, hidden) -> torch.Tensor:
    """Pooler (tanh of the first token's state) and the classification
    head: [bsz, num_labels]."""
    cd = cfg.cdtype
    pooled = torch.tanh(_linear(hidden[:, 0], params, "pooler_w", "pooler_b",
                                cd))
    return _linear(pooled, params, "classifier_w", "classifier_b", cd)


def bert_discriminator_score(params, cfg: BertConfig, inputs_embeds, *,
                             train: bool = False,
                             dropout_u: DropoutDraws | None = None
                             ) -> torch.Tensor:
    """The GAN critic's score [bsz]: the class-0 logit of the classifier."""
    hidden = bert_encode(params, cfg, inputs_embeds=inputs_embeds,
                         train=train, dropout_u=dropout_u)
    return bert_cls_logits(params, cfg, hidden)[:, 0]


def trunk_names(params) -> list[str]:
    """The encoder trunk's parameters (embeddings, their LayerNorm and the
    layers): what an MLM checkpoint hands the critic."""
    return [k for k in params if "embedding" in k or k.startswith("emb_ln")
            or k.startswith("layers.")]
