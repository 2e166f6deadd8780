"""The port's MLM pretraining on 2 gloo ranks (``parallel/mesh.spawn``, a
``file://`` store) against the JAX package's ``MlmTrainer`` on a 2-device
mesh, fp32 on the CPU at the tiny width of ``test_torch_mlm.py`` (2
layers, hidden 24, block 16, a global batch of 4 blocks, 2 a rank):

* one update from the same parameters, batch, masks and dropout draws (the
  JAX step's, drawn at the global shape and handed to each rank by
  ``parallel/sharding.MlmRowDraws``), the two ranks' masked counts unequal:
  the loss (the ranks' shares summed) within rtol 1e-6, Adam's first
  moment within rtol 2e-4, atol 1e-8, the moves within 1e-3 lr but for at
  most 0.1% of the weights, each within 2 lr (the bounds of
  ``test_torch_mlm.test_mlm_trainer_update_matches_jax``), the ranks'
  parameters bitwise equal;
* the data-parallel trainer's evaluation equal to the one-process one
  (rtol 1e-6; its masks are drawn at the global shape), the trainer's own
  training draws rank 0's those of one process and rank 1's others, and
  the CLI on 2 ranks: a global batch of
  ``per_gpu_train_batch_size`` x 2, one set of rotated checkpoints.

JAX is imported inside the tests only: the rank processes import this
module to find their functions."""

import os

import numpy as np
import torch

from chip_smoke import write_random_corpus
from transformer_gan_torch.bert import mlm as tmlm
from transformer_gan_torch.config import PACKAGED_VOCAB
from transformer_gan_torch.parallel import mesh as pmesh
from transformer_gan_torch.parallel import sharding as psh

torch.set_num_threads(1)

COMMON = dict(vocab_file=PACKAGED_VOCAB, num_hidden_layers=2, hidden_size=24,
              block_size=16, batch_size=4, max_steps=4, seed=5,
              learning_rate=5e-5)


class _Global(tmlm.MlmDraws):
    """Recorded global draws: the masking tuple, then the dropout sites in
    order."""

    def __init__(self, mask, sites):
        self._mask, self._sites = mask, iter(sites)

    def mask(self, shape, vocab_size):
        assert tuple(self._mask[0].shape) == tuple(shape)
        return self._mask

    def dropout_u(self, shape):
        u = next(self._sites)
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return u


def _corpus(tmp_path):
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=6, train_len=70,
                        n_eval=4, eval_len=70, seed=0)
    return data


def _step_rank(mesh, data, out, batch, mask, sites):
    tr = tmlm.MlmTrainer(data_dir=data, output_dir=out, device="cpu",
                         **COMMON)
    before = tr.flat.clone()
    loss = tr.train_step(tr._local(batch),
                         psh.MlmRowDraws(_Global(mask, sites)))
    return {"loss": float(loss), "flat": tr.flat.clone(), "before": before,
            "mu": tr.opt_state.mu.clone(), "eval": tr.evaluate(),
            "own": tr.draws.dropout_u((2, 3))}


def test_mlm_step_matches_jax_mesh(tmp_path):
    import jax
    import jax.numpy as jnp
    from test_torch_bert import jax_dropout_draws, to_torch
    from transformer_gan_tpu.bert import mlm as jmlm
    from transformer_gan_tpu.parallel import mesh as jmesh

    data = _corpus(tmp_path)
    jt = jmlm.MlmTrainer(output_dir=str(tmp_path / "jax"), data_dir=data,
                         mesh=jmesh.make_mesh(2), **COMMON)
    batch = jt.train_blocks[:4]
    key = jax.random.PRNGKey(9)
    r_mask, r_drop = jax.random.split(key)
    r1, r2, r3, r4 = jax.random.split(r_mask, 4)
    shape = batch.shape
    mask = tuple(torch.from_numpy(np.array(x)) for x in (
        jax.random.uniform(r1, shape, jnp.float32),
        jax.random.uniform(r2, shape, jnp.float32),
        jax.random.uniform(r3, shape, jnp.float32),
        jax.random.randint(r4, shape, 0, 311)))
    sites = jax_dropout_draws(r_drop, jt.cfg, *shape)
    # the two ranks' rows hold different numbers of masked tokens
    tok = tmlm.MIDITokenizer(PACKAGED_VOCAB)
    _, labels = tmlm.mask_tokens(torch.from_numpy(batch), tok.mask_token_id,
                                 len(tok), tok.pad_token_id, 0.15,
                                 _Global(mask, []))
    counts = [int((labels[r * 2:(r + 1) * 2] >= 0).sum()) for r in range(2)]
    assert counts[0] != counts[1], counts
    ranks = pmesh.spawn(_step_rank, 2, data, str(tmp_path / "port"), batch,
                        mask, sites)
    jparams, jopt, jloss = jt._train_step(jt.params, jt.opt_state,
                                          jt._place(batch), key)
    np.testing.assert_allclose(sum(r["loss"] for r in ranks), float(jloss),
                               rtol=1e-6)
    assert torch.equal(ranks[0]["flat"], ranks[1]["flat"])
    layout = tmlm.topt.FlatLayout.of(to_torch(jt.params))
    adam = next(s for s in jopt if hasattr(s, "mu"))
    np.testing.assert_allclose(
        ranks[0]["mu"].numpy(), layout.flatten(to_torch(adam.mu)).numpy(),
        rtol=2e-4, atol=1e-8)
    lr, before = COMMON["learning_rate"], ranks[0]["before"]
    diff = ((ranks[0]["flat"] - before)
            - (layout.flatten(to_torch(jparams)) - before)).abs()
    assert float((diff > 1e-3 * lr).float().mean()) < 1e-3
    assert float(diff.max()) <= 2 * lr
    # the evaluation of the updated weights against one process's
    one = tmlm.MlmTrainer(data_dir=data, output_dir=str(tmp_path / "one"),
                          device="cpu", **COMMON)
    with torch.no_grad():
        one.flat.copy_(ranks[0]["flat"])
    assert len(one.valid_blocks) >= 8
    np.testing.assert_allclose([r["eval"] for r in ranks],
                               [one.evaluate()] * 2, rtol=1e-6)
    # a training step's own draws: rank 0 one process's, rank 1 others
    own = one.draws.dropout_u((2, 3))
    assert torch.equal(ranks[0]["own"], own)
    assert not torch.equal(ranks[1]["own"], own)


def _cli_rank(mesh, argv):
    from transformer_gan_torch.cli import bert_pretrain
    tr = bert_pretrain.main(argv)
    return {"batch": tr.batch_size, "step": tr.step, "flat": tr.flat.clone()}


def test_cli_bert_pretrain_two_ranks(tmp_path):
    data, out = _corpus(tmp_path), str(tmp_path / "bert")
    ranks = pmesh.spawn(_cli_rank, 2, [
        "--train_data_file", data, "--output_dir", out, "--vocab_file",
        PACKAGED_VOCAB, "--num_hidden_layers", "1", "--hidden_size", "24",
        "--block_size", "16", "--per_gpu_train_batch_size", "2",
        "--max_steps", "4", "--logging_steps", "2", "--save_steps", "2",
        "--eval_steps", "2", "--device", "cpu"])
    assert [r["batch"] for r in ranks] == [4, 4]
    assert [r["step"] for r in ranks] == [4, 4]
    assert torch.equal(ranks[0]["flat"], ranks[1]["flat"])
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4"]
    saved = tmlm.ckpt.load_bert_params(os.path.join(out, "checkpoint-4"))
    layout = tmlm.topt.FlatLayout.of(saved)
    assert torch.equal(layout.flatten(saved), ranks[0]["flat"])
