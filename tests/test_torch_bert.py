"""The port's BERT stack against the JAX package, fp32 on the CPU at a tiny
width (2 layers, hidden 24, 4 heads, intermediate 48, vocab 311):

* the MIDI tokenizer on the packaged vocab;
* ``init_bert_params`` bit for bit for the same seed;
* ``bert_encode``, the MLM and CLS logits and ``bert_discriminator_score``
  from ids or embeddings, with and without an attention mask, at dropout 0
  and with the JAX package's dropout draws recomputed from its key
  (:func:`jax_dropout_draws`). Outputs within rtol 1e-5 / atol 1e-6 of
  max|out|; gradients to the parameters and to ``inputs_embeds`` within
  rtol 2e-4 / atol 1e-7 (the GAN tests' gradient bounds)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch.bert.tokenizer import MIDITokenizer as TTok
from transformer_gan_torch.config import PACKAGED_VOCAB
from transformer_gan_torch.models import bert as tbert
from transformer_gan_tpu.bert.tokenizer import MIDITokenizer as JTok
from transformer_gan_tpu.models import bert as jbert

torch.set_num_threads(1)

TINY = dict(vocab_size=311, hidden_size=24, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=48,
            max_position_embeddings=32)


def flat_tree(tree, prefix=""):
    """A JAX pytree of dicts and lists as the port's dotted names."""
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


def to_torch(tree, grad: bool = False) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32)).requires_grad_(grad)
            for k, v in flat_tree(tree).items()}


def jax_dropout_draws(rng, cfg, bsz: int, seq: int) -> list:
    """The uniform draws behind the JAX ``bert_encode``'s dropout from
    ``rng``, in the port's site order: the embeddings, then per layer the
    probabilities, the attention output and the feed-forward output."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    rng, r = jax.random.split(rng)
    out = [jax.random.uniform(r, (bsz, seq, h), jnp.float32)]
    for _ in range(cfg.num_hidden_layers):
        rng, r_att, r_h1, r_h2 = jax.random.split(rng, 4)
        out += [jax.random.uniform(r_att, (bsz, nh, seq, seq), jnp.float32),
                jax.random.uniform(r_h1, (bsz, seq, h), jnp.float32),
                jax.random.uniform(r_h2, (bsz, seq, h), jnp.float32)]
    return [torch.from_numpy(np.array(u)) for u in out]


def replay(draws: list):
    """A ``dropout_u`` callable handing out ``draws`` in order, checking
    each site's shape."""
    it = iter(draws)

    def dropout_u(shape):
        u = next(it)
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return u

    return dropout_u


def assert_close(got, ref, rtol, atol_rel, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_rel * float(np.abs(ref).max()),
                               err_msg=msg)


def test_tokenizer_matches_jax():
    j, t = JTok(PACKAGED_VOCAB), TTok(PACKAGED_VOCAB)
    assert list(t.vocab.items()) == list(j.vocab.items())
    assert t.ids_to_tokens == j.ids_to_tokens
    assert (len(t), t.pad_token_id, t.mask_token_id) == \
        (len(j), j.pad_token_id, j.mask_token_id) == (311, 1, 310)
    assert t.convert_ids_to_tokens(1) == "[PAD]"
    assert t.convert_tokens_to_ids("[MASK]") == 310


@pytest.mark.parametrize("shape", ["tiny", "full_width"])
def test_init_bert_params_matches_jax(shape):
    """Bit for bit, every leaf and its name (the full width is the critic's
    and the MLM trainer's, 5 layers of hidden 768)."""
    kw = TINY if shape == "tiny" else {}
    jp = jbert.init_bert_params(jbert.BertConfig(**kw), seed=42)
    tp = tbert.init_bert_params(tbert.BertConfig(**kw), seed=42)
    ref = flat_tree(jp)
    assert set(tp) == set(ref)
    for k, v in ref.items():
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), v, err_msg=k)
    assert sorted(tbert.trunk_names(tp)) == sorted(
        k for k in ref if not k.startswith(("pooler", "classifier", "mlm")))


def _inputs(rng, bsz, seq, use_mask):
    ids = rng.randint(0, 311, (bsz, seq))
    embeds = (rng.randn(bsz, seq, 24) * 0.5).astype(np.float32)
    mask = None
    if use_mask:
        mask = np.ones((bsz, seq), np.int32)
        mask[0, seq - 3:] = 0
        mask[2, 1:4] = 0
    return ids, embeds, mask


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("inputs", ["ids", "embeds", "ids_masked",
                                    "embeds_masked"])
def test_bert_heads_and_grads_match_jax(inputs, dropout):
    """Hidden states, MLM logits, CLS logits and the critic's score; the
    gradients of a fixed linear functional of all four (random weights over
    each output's size, a loss-like mean) in every parameter (and in
    ``inputs_embeds``)."""
    bsz, seq = 3, 10
    jcfg, tcfg = jbert.BertConfig(**TINY), tbert.BertConfig(**TINY)
    jp = jbert.init_bert_params(jcfg, seed=3)
    rng = np.random.RandomState(5)
    ids, embeds, mask = _inputs(rng, bsz, seq, inputs.endswith("masked"))
    from_ids = inputs.startswith("ids")
    key = jax.random.PRNGKey(8)
    weights = [rng.randn(bsz, seq, 24), rng.randn(bsz, seq, 311),
               rng.randn(bsz, 2), rng.randn(bsz)]
    weights = [(w / w.size).astype(np.float32) for w in weights]

    def jfwd(p, emb):
        hidden = jbert.bert_encode(
            p, jcfg, input_ids=jnp.asarray(ids) if from_ids else None,
            inputs_embeds=None if from_ids else emb,
            attention_mask=None if mask is None else jnp.asarray(mask),
            train=dropout, rng=key if dropout else None)
        outs = (hidden, jbert.bert_mlm_logits(p, jcfg, hidden),
                jbert.bert_cls_logits(p, jcfg, hidden))
        if not from_ids and mask is None:
            outs += (jbert.bert_discriminator_score(
                p, jcfg, emb, train=dropout, rng=key if dropout else None),)
        return outs

    def jsum(p, emb):
        return sum(jnp.sum(o * w) for o, w in zip(jfwd(p, emb), weights))

    jouts = jfwd(jp, jnp.asarray(embeds))
    jg_p, jg_e = jax.grad(jsum, argnums=(0, 1))(jp, jnp.asarray(embeds))

    tp = to_torch(jp, grad=True)
    temb = torch.from_numpy(embeds).requires_grad_(True)
    draws = jax_dropout_draws(key, jcfg, bsz, seq) if dropout else []

    def kw():      # each call with the same key draws the same numbers
        return dict(train=dropout,
                    dropout_u=replay(draws) if dropout else None)

    def tfwd():
        hidden = tbert.bert_encode(
            tp, tcfg, input_ids=torch.from_numpy(ids) if from_ids else None,
            inputs_embeds=None if from_ids else temb,
            attention_mask=None if mask is None else torch.from_numpy(mask),
            **kw())
        outs = (hidden, tbert.bert_mlm_logits(tp, tcfg, hidden),
                tbert.bert_cls_logits(tp, tcfg, hidden))
        if not from_ids and mask is None:
            outs += (tbert.bert_discriminator_score(tp, tcfg, temb, **kw()),)
        return outs

    touts = tfwd()
    assert len(touts) == len(jouts)
    for name, got, ref in zip(("hidden", "mlm", "cls", "score"), touts, jouts):
        assert_close(got.detach().numpy(), ref, 1e-5, 1e-6, name)
    total = sum((o * torch.from_numpy(w)).sum() for o, w in zip(touts, weights))
    total.backward()
    for k, g in flat_tree(jg_p).items():
        got = tp[k].grad if tp[k].grad is not None else torch.zeros_like(tp[k])
        np.testing.assert_allclose(got.numpy(), g, rtol=2e-4, atol=1e-7,
                                   err_msg=k)
    if not from_ids:
        np.testing.assert_allclose(temb.grad.numpy(), np.asarray(jg_e),
                                   rtol=2e-4, atol=1e-7)


def test_bert_dropout_sites_and_scale():
    """The dropout sites' shapes in the order ``dropout_u`` is called (the
    embeddings, then per layer the probabilities and the two residual
    branches); at rate 0 no draw is taken and train equals eval."""
    cfg = tbert.BertConfig(**TINY)
    p = tbert.init_bert_params(cfg, seed=1)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 311, (2, 6)))
    calls = []

    def record(shape):
        calls.append(tuple(shape))
        return torch.zeros(shape)

    tbert.bert_encode(p, cfg, input_ids=ids, train=True, dropout_u=record)
    h, nh = 24, 4
    assert calls == [(2, 6, h)] + [(2, nh, 6, 6), (2, 6, h), (2, 6, h)] * 2
    off = dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)
    torch.testing.assert_close(
        tbert.bert_encode(p, off, input_ids=ids, train=True,
                          dropout_u=record),
        tbert.bert_encode(p, cfg, input_ids=ids), rtol=0, atol=0)
    assert len(calls) == 7     # no draws at rate 0
