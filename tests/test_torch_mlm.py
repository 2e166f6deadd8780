"""The port's MLM pretraining against the JAX package, fp32 on the CPU at a
tiny width (2 layers, hidden 24, block 16):

* ``load_block_dataset`` equal to JAX's;
* ``mask_tokens``: equal to ``mask_tokens_jax`` on the JAX package's draws;
  its invariants (pads never masked, labels -100 off the mask, unmasked
  tokens unchanged) and its 80/10/10 shares within 5 binomial sigmas;
* ``mlm_loss`` on the same masked batch, with and without dropout (the JAX
  draws), within rtol 1e-6;
* one ``MlmTrainer`` update against the JAX trainer's jitted step and optax
  chain from the same parameters, batch, masks and dropout draws: Adam's
  first moment, 0.1 x the clipped gradient, within the gradient bounds
  (rtol 2e-4, atol 1e-8 = 0.1 x 1e-7), the moves as in
  ``test_torch_gan.test_gan_phases_step_matches_jax`` (Adam's first step
  moves a weight by about lr whatever its gradient: within 1e-3 lr but for
  at most 0.1% of the weights, each within 2 lr), with and without weight
  decay (its mask differs from the critic's);
* the CLI on the CPU: eval, rotated ``checkpoint-{step}`` saves, metadata."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_random_corpus
from test_torch_bert import flat_tree, jax_dropout_draws, replay, to_torch
from transformer_gan_torch.bert import mlm as tmlm
from transformer_gan_torch.bert.tokenizer import MIDITokenizer
from transformer_gan_torch.config import PACKAGED_VOCAB
from transformer_gan_torch.models import bert as tbert
from transformer_gan_tpu.bert import mlm as jmlm
from transformer_gan_tpu.models import bert as jbert

torch.set_num_threads(1)

V = 311


class JaxMlmDraws(tmlm.MlmDraws):
    """The draws of the JAX trainer's step on ``key``: masking from the
    first half of split(key), dropout from the second."""

    def __init__(self, key, cfg, bsz: int, seq: int):
        r_mask, r_drop = jax.random.split(key)
        r1, r2, r3, r4 = jax.random.split(r_mask, 4)
        shape = (bsz, seq)
        self._mask = tuple(torch.from_numpy(np.array(x)) for x in (
            jax.random.uniform(r1, shape, jnp.float32),
            jax.random.uniform(r2, shape, jnp.float32),
            jax.random.uniform(r3, shape, jnp.float32),
            jax.random.randint(r4, shape, 0, V)))
        self.dropout_u = replay(jax_dropout_draws(r_drop, cfg, bsz, seq))
        self.r_mask = r_mask

    def mask(self, shape, vocab_size):
        return self._mask


def _corpus(tmp_path, seed=0):
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=6, train_len=70,
                        n_eval=2, eval_len=40, seed=seed)
    return data


def test_load_block_dataset_matches_jax(tmp_path):
    data = _corpus(tmp_path)
    tok = MIDITokenizer(PACKAGED_VOCAB)
    for split in ("train", "valid"):
        got = tmlm.load_block_dataset(os.path.join(data, split), tok, 16)
        ref = jmlm.load_block_dataset(os.path.join(data, split), tok, 16)
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        assert (got[:, -1] == 1).any()          # padded tails
    with pytest.raises(ValueError):
        tmlm.load_block_dataset(str(tmp_path), tok, 16)


def _batch(rng, bsz, seq):
    ids = rng.randint(2, 310, (bsz, seq))
    ids[0, seq // 2:] = 1                      # a padded tail
    return ids


def test_mask_tokens_matches_jax():
    ids = _batch(np.random.RandomState(1), 6, 40)
    cfg = jbert.BertConfig(hidden_size=24, num_hidden_layers=1)
    key = jax.random.PRNGKey(4)
    draws = JaxMlmDraws(key, cfg, *ids.shape)
    jout, jlab = jmlm.mask_tokens_jax(draws.r_mask, jnp.asarray(ids), 310, V, 1)
    tout, tlab = tmlm.mask_tokens(torch.from_numpy(ids), 310, V, 1, 0.15,
                                  draws)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))


def test_mask_tokens_invariants_and_shares():
    """80/10/10 of 15%: over ~50k tokens every share within 5 binomial
    sigmas (a random replacement can hit the token itself or [MASK], 2 in
    311, counted in the expectation)."""
    rng = np.random.RandomState(2)
    ids = torch.from_numpy(_batch(rng, 400, 128))
    draws = tmlm.MlmDraws(torch.Generator().manual_seed(3))
    out, lab = tmlm.mask_tokens(ids, 310, V, 1, 0.15, draws)
    pad = ids == 1
    masked = lab != -100
    assert not (masked & pad).any()
    assert torch.equal(lab[masked], ids[masked])
    assert torch.equal(out[~masked], ids[~masked])

    def within(count, n, p):
        sigma = (n * p * (1 - p)) ** 0.5
        assert abs(count - n * p) <= 5 * sigma, (count, n, p)

    n_tok, n_mask = int((~pad).sum()), int(masked.sum())
    within(n_mask, n_tok, 0.15)
    o, i = out[masked], ids[masked]
    within(int((o == 310).sum()), n_mask, 0.8 + 0.1 / V)
    within(int(((o != 310) & (o != i)).sum()), n_mask, 0.1 * (V - 2) / V)
    within(int((o == i).sum()), n_mask, 0.1 + 0.1 / V)


@pytest.mark.parametrize("dropout", [False, True])
def test_mlm_loss_matches_jax(dropout):
    kw = dict(vocab_size=V, hidden_size=24, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=48,
              max_position_embeddings=32)
    jcfg, tcfg = jbert.BertConfig(**kw), tbert.BertConfig(**kw)
    jp = jbert.init_bert_params(jcfg, seed=2)
    ids = _batch(np.random.RandomState(3), 4, 16)
    key = jax.random.PRNGKey(6)
    draws = JaxMlmDraws(key, jcfg, *ids.shape)
    masked, labels = jmlm.mask_tokens_jax(draws.r_mask, jnp.asarray(ids), 310,
                                          V, 1)
    r_drop = jax.random.split(key)[1]
    ref = jmlm.mlm_loss(jp, jcfg, masked, labels, r_drop if dropout else None,
                        dropout)
    got = tmlm.mlm_loss(to_torch(jp), tcfg, torch.from_numpy(np.array(masked)),
                        torch.from_numpy(np.array(labels)), train=dropout,
                        dropout_u=draws.dropout_u)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def _trainers(tmp_path, **kw):
    data = _corpus(tmp_path)
    common = dict(data_dir=data, vocab_file=PACKAGED_VOCAB,
                  num_hidden_layers=2, hidden_size=24, block_size=16,
                  batch_size=4, max_steps=4, seed=5, **kw)
    jt = jmlm.MlmTrainer(output_dir=str(tmp_path / "jax"), **common)
    tt = tmlm.MlmTrainer(output_dir=str(tmp_path / "port"), device="cpu",
                         **common)
    return jt, tt


@pytest.mark.parametrize("weight_decay", [0.0, 1.0])
def test_mlm_trainer_update_matches_jax(tmp_path, weight_decay):
    jt, tt = _trainers(tmp_path, weight_decay=weight_decay,
                       learning_rate=5e-5)
    layout = tt.layout
    before = tt.flat.clone()
    np.testing.assert_array_equal(before.numpy(),
                                  layout.flatten(to_torch(jt.params)).numpy())
    batch = jt.train_blocks[:4]
    key = jax.random.PRNGKey(9)
    jparams, jopt, jloss = jt._train_step(jt.params, jt.opt_state,
                                          jnp.asarray(batch), key)
    loss = tt.train_step(torch.from_numpy(batch),
                         JaxMlmDraws(key, jt.cfg, *batch.shape))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert tt.opt_state.count == 1
    adam = next(s for s in jopt if hasattr(s, "mu"))
    np.testing.assert_allclose(
        tt.opt_state.mu.numpy(), layout.flatten(to_torch(adam.mu)).numpy(),
        rtol=2e-4, atol=1e-8)
    lr = 5e-5
    diff = ((tt.flat - before)
            - (layout.flatten(to_torch(jparams)) - before)).abs()
    assert float((diff > 1e-3 * lr).float().mean()) < 1e-3
    assert float(diff.max()) <= 2 * lr
    # the decay mask: no decay on *_b*, ln and bias names (ffn_b1 included)
    decayed = {n for n in layout.names if tmlm.mlm_decay_mask(n)}
    assert "layers.0.ffn_b1" not in decayed and "layers.0.ffn_w1" in decayed
    assert "word_embeddings" in decayed and "mlm_bias" not in decayed


def test_cli_bert_pretrain_on_cpu(tmp_path):
    """Eval at step 2 and 4, saves at 2, 4 and 6 with save_total_limit 2,
    a finite loss on the log, the checkpoint's parameters and metadata."""
    from transformer_gan_torch.cli import bert_pretrain
    data, out = _corpus(tmp_path), str(tmp_path / "bert")
    tr = bert_pretrain.main([
        "--train_data_file", data, "--output_dir", out, "--vocab_file",
        PACKAGED_VOCAB, "--num_hidden_layers", "1", "--hidden_size", "24",
        "--block_size", "16", "--per_gpu_train_batch_size", "4",
        "--max_steps", "6", "--logging_steps", "1", "--save_steps", "2",
        "--eval_steps", "2", "--device", "cpu"])
    assert tr.step == 6
    assert sorted(os.listdir(out)) == ["checkpoint-4", "checkpoint-6"]
    with open(os.path.join(out, "checkpoint-6", "metadata.json")) as f:
        meta = json.load(f)
    assert meta == {"step": 6, "config": {"vocab_size": V,
                                          "num_hidden_layers": 1,
                                          "hidden_size": 24}}
    losses = [h["loss"] for h in tr.history if "loss" in h]
    evals = [h["eval_loss"] for h in tr.history if "eval_loss" in h]
    assert len(losses) == 6 and len(evals) == 3
    assert all(np.isfinite(losses + evals))
    saved = tmlm.ckpt.load_bert_params(os.path.join(out, "checkpoint-6"))
    live = tr.params()
    assert set(saved) == set(live)
    assert all(torch.equal(saved[k], live[k]) for k in live)
    assert set(flat_tree(jbert.init_bert_params(jbert.BertConfig(
        hidden_size=24, num_hidden_layers=1)))) == set(saved)
