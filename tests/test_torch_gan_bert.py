"""The port's GAN phases with the BERT critic (wgan-gp) against the JAX
package, fp32 on the CPU at a tiny width (generator: 2 layers, 2 heads,
d_model 16, V 310; critic: 2 layers, hidden 24, 4 heads, vocab 311), where
the sampler and chain kernels' wrappers run their plain versions:

* ``score_chunk`` and ``chunk_gradient_penalty`` with the same interpolation
  weights, with and without the critic's dropout (the JAX draws);
* ``gan_losses_for_batch`` for the dis and the gen phase with the JAX
  package's draws (a ``Draws`` subclass recomputes its gumbel noise, the
  critic's dropout draws and the penalty weights from its key). Losses
  within rtol 1e-6, gradients within rtol 2e-4 / atol 1e-7, the bounds of
  ``test_torch_gan.py``;
* the critic's optimizer against the JAX package's ``_masked`` chain on
  parameters and gradients drawn with numpy: frozen leaves, their Adam
  moments and their updates exactly unchanged (their gradients, 1000x the
  others', left out of the clip norm), weight decay on the critic's mask,
  the moments within rtol 2e-4 / atol 1e-6 of their largest entry;
* one ``GanPhases`` dis and gen step with ``freeze_layers``: frozen leaves and
  their moments bitwise unchanged, the rest as JAX's;
* the critic's config from an MLM checkpoint's metadata, the trunk graft,
  a JAX MLM checkpoint through the numpy archive, and the training CLI on a
  tiny spanbert config (``--device cpu``) after ``cli.bert_pretrain``, with
  a restart."""

import os
import types
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from chip_smoke import write_random_corpus
from test_torch_bert import TINY, flat_tree, jax_dropout_draws, replay, to_torch
from test_torch_gan import BASE, PHASE_CFG, JaxDraws, _adam_mu, _jax_cfg
from transformer_gan_torch import convert
from transformer_gan_torch.config import PACKAGED_VOCAB, training_config
from transformer_gan_torch.models import bert as tbert
from transformer_gan_torch.models import gan as tgan
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.train import checkpoint as tckpt
from transformer_gan_torch.train import gan_loop as tloop
from transformer_gan_torch.train import optim as topt
from transformer_gan_tpu.models import bert as jbert
from transformer_gan_tpu.models import gan as jgan
from transformer_gan_tpu.models import xl as jxl

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 310


class JaxBertDraws(JaxDraws):
    """:class:`test_torch_gan.JaxDraws` with the BERT critic's dropout: per
    scored chunk the draws of every site from that chunk's score key."""

    def __init__(self, key, chunks: int, cfg):
        super().__init__(key, chunks)
        self.cfg, self.replays = cfg, {}

    def dropout_u(self, chunk, shape):
        if chunk not in self.replays:        # the first site: [2b, len, h]
            self.replays[chunk] = replay(jax_dropout_draws(
                self.chunk_rngs[chunk][0], self.cfg, shape[0], shape[1]))
        return self.replays[chunk](shape)


def _critic(seed=1):
    jcfg, tcfg = jbert.BertConfig(**TINY), tbert.BertConfig(**TINY)
    return jcfg, tcfg, jbert.init_bert_params(jcfg, seed=seed)


GCOMMON = dict(dis_type="bert", loss_type="wgan-gp", tgt_len=16, mem_len=16,
               context_len=3, sample_chunks_mem=2, n_token=V)


@pytest.mark.parametrize("train", [False, True])
def test_score_and_penalty_match_jax(train):
    """Real and fake of one chunk scored in one call; the penalty on one-hot
    interpolates over V + 1; every critic gradient of score + penalty."""
    jcfg, tcfg, jp = _critic()
    jg, tg = jgan.GanConfig(**GCOMMON), tgan.GanConfig(**GCOMMON)
    rng = np.random.RandomState(4)
    real = rng.randint(2, V, (8, 5))
    fake = rng.dirichlet(np.ones(V) * 0.1, (8, 5)).astype(np.float32)
    key, gp_key = jax.random.PRNGKey(3), jax.random.PRNGKey(7)
    w = rng.randn(2, 5).astype(np.float32)

    def jtotal(p):
        dr, df = jgan.score_chunk(p, jcfg, jg, jnp.asarray(real),
                                  jnp.asarray(fake), train=train,
                                  rng=key if train else None)
        gp = jgan.chunk_gradient_penalty(p, jcfg, jg, jnp.asarray(real),
                                         jnp.asarray(fake), gp_key)
        return jnp.sum(dr * w[0]) + jnp.sum(df * w[1]) + gp, (dr, df, gp)

    (_, (jdr, jdf, jgp)), jgrad = jax.jit(jax.value_and_grad(
        jtotal, has_aux=True))(jp)
    tp = to_torch(jp, grad=True)
    u = (replay(jax_dropout_draws(key, jcfg, 10, 8)) if train else None)
    dr, df = tgan.score_chunk(tp, tcfg, tg, torch.from_numpy(real),
                              torch.from_numpy(fake), train=train,
                              dropout_u=u)
    alpha = torch.from_numpy(np.array(jax.random.uniform(
        gp_key, (5, 1, 1), jnp.float32)))
    gp = tgan.chunk_gradient_penalty(tp, tcfg, tg, torch.from_numpy(real),
                                     torch.from_numpy(fake), alpha)
    for got, ref in ((dr, jdr), (df, jdf), (gp, jgp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
    ((dr * torch.from_numpy(w[0])).sum() + (df * torch.from_numpy(w[1])).sum()
     + gp).backward()
    for k, g in flat_tree(jgrad).items():
        got = tp[k].grad if tp[k].grad is not None else torch.zeros_like(tp[k])
        np.testing.assert_allclose(got.numpy(), g, rtol=2e-4, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("phase", ["dis", "gen"])
def test_gan_losses_for_batch_match_jax(phase):
    """The dis phase: dis_loss and gp_loss (critic dropout on) and every
    critic gradient. The gen phase: gen_loss through the critic's embedding
    product into the reverse chain, and every generator gradient."""
    jxcfg = jxl.XLConfig(cache_kv=True, use_pallas=False, **BASE)
    txcfg = txl.XLConfig(**BASE)
    jgp = jxl.init_xl_params(jxcfg, seed=0)
    jg = jgan.GanConfig(decode_cache="chunked", chain_bwd="jnp", **GCOMMON)
    tg = tgan.GanConfig(**GCOMMON)
    jcfg, tcfg, jdp = _critic(seed=2)
    data = np.random.RandomState(3).randint(2, V, (16, 8))
    key, T, dis = jax.random.PRNGKey(12), 0.9, phase == "dis"

    def jloss(gp, dp):
        losses, _ = jgan.gan_losses_for_batch(gp, dp, jcfg, jxcfg, jg,
                                              jnp.asarray(data), T, key,
                                              train_dis=dis)
        total = (losses["dis_loss"] + losses["gp_loss"] if dis
                 else losses["gen_loss"])
        return total, losses

    (_, jl), jgrad = jax.jit(jax.value_and_grad(
        jloss, argnums=1 if dis else 0, has_aux=True))(jgp, jdp)
    tgp, tdp = to_torch(jgp, grad=not dis), to_torch(jdp, grad=dis)
    losses = tgan.gan_losses_for_batch(
        tgp, tdp, tcfg, txcfg, tg, torch.from_numpy(data), T,
        JaxBertDraws(key, 2, jcfg), train_dis=dis)
    names = ("dis_loss", "gp_loss") if dis else ("gen_loss",)
    sum(losses[k] for k in names).backward()
    for k in names:
        np.testing.assert_allclose(float(losses[k].detach()), float(jl[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    params = tdp if dis else tgp
    for k, g in flat_tree(jgrad).items():
        got = (params[k].grad if params[k].grad is not None
               else torch.zeros_like(params[k]))
        np.testing.assert_allclose(got.numpy(), g, rtol=2e-4, atol=1e-7,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The critic's optimizer and GanPhases
# ---------------------------------------------------------------------------

def _bert_phase_cfg(tmp_path, freeze, random_weights=False, **bert):
    return {**PHASE_CFG, "DISCRIMINATOR": {
        **PHASE_CFG["DISCRIMINATOR"], "type": "bert",
        "BERT": {"hidden_size": 24, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "intermediate_size": 48,
                 "loss_type": "wgan-gp", "learning_rate": 1e-3,
                 "model_path": str(tmp_path / "missing"),
                 "freeze_layers": freeze, "random_weights": random_weights,
                 **bert}}}


@pytest.mark.parametrize("freeze,random_weights", [
    (["0"], False), (["0", "1"], False), ([], True), (["1"], True)])
def test_critic_optimizer_matches_jax_masked(tmp_path, freeze,
                                             random_weights):
    """Two updates of the critic's optimizer (clip 1.0, weight decay 0.5)
    on seeded parameters whose every leaf, biases included, is nonzero, and
    seeded gradients 1000x larger on the frozen leaves: the parameters and
    Adam's moments against the JAX chain, frozen entries exactly as before
    and their moments exactly 0."""
    from transformer_gan_tpu.train import gan_loop as jloop
    over = _bert_phase_cfg(tmp_path, freeze, random_weights, weight_decay=0.5)
    jcfg, tcfg = _jax_cfg(over), training_config().merge(over)
    rng = np.random.RandomState(6)
    jp = jax.tree.map(lambda x: jnp.asarray(
        rng.randn(*x.shape).astype(np.float32)),
        jbert.init_bert_params(jbert.BertConfig(**TINY)))
    jopt, jmask, _ = jloop._make_dis_optimizer(jcfg, jp)
    layout = topt.FlatLayout.of(to_torch(jp))
    frozen = tloop._bert_frozen(layout.names, freeze, random_weights)
    assert sorted(frozen) == sorted(
        k for k, v in flat_tree(jmask).items() if not v)
    _, _, dis_opt, _ = topt.make_gan_optimizers(
        tcfg, layout, layout, trainable=layout.mask(
            lambda n: n not in frozen))
    flat = layout.flatten(to_torch(jp))
    before = flat.clone()
    state, jstate = dis_opt.init(flat), jopt.init(jp)
    for step in range(2):
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.randn(*x.shape).astype(np.float32)), jp)
        g = jax.tree.map(lambda x, m: x if m else x * 1000.0, g, jmask)
        updates, jstate = jopt.update(g, jstate, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, updates)
        state = dis_opt.update(flat, layout.flatten(to_torch(g)), state)
    fmask = layout.mask(lambda n: n in frozen)
    ref = layout.flatten(to_torch(jp))
    assert torch.equal(flat[fmask], before[fmask])
    assert torch.equal(ref[fmask], before[fmask])
    np.testing.assert_allclose(flat.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-7)
    for mine, theirs in ((state.mu, _adam_mu(jstate)),
                         (state.nu, _adam_nu(jstate))):
        assert not mine[fmask].any()
        ref = layout.flatten(to_torch(theirs)).numpy()
        np.testing.assert_allclose(mine.numpy(), ref, rtol=2e-4,
                                   atol=1e-6 * np.abs(ref).max())


def _adam_nu(state):
    import optax
    if isinstance(state, optax.ScaleByAdamState):
        return state.nu
    if isinstance(state, tuple):
        for s in state:
            nu = _adam_nu(s)
            if nu is not None:
                return nu
    return None


def test_gan_phases_bert_step_matches_jax(tmp_path):
    """One dis update (wgan-gp, critic dropout 0.1, the JAX draws) and one
    gen update of GanPhases with layer 0 frozen and the embeddings frozen
    (no checkpoint, random_weights off): frozen critic leaves and their Adam
    moments bitwise unchanged; Adam's first moments of both phases within
    the gradient bounds (rtol 2e-4, atol 1e-8 = 0.1 x 1e-7); the moves as in
    ``test_torch_gan.test_gan_phases_step_matches_jax``."""
    from transformer_gan_tpu.train import gan_loop as jloop
    over = _bert_phase_cfg(tmp_path, ["0"])
    jcfg, tcfg = _jax_cfg(over), training_config().merge(over)
    jxcfg = jxl.XLConfig.from_cfg(jcfg, V)
    txcfg = txl.XLConfig.from_cfg(tcfg, V)
    jp = jxl.init_xl_params(jxcfg, seed=0, base_init=("normal", 0.1))
    rng = np.random.RandomState(2)
    batches = [(rng.randint(2, V, (16, 8)), 128) for _ in range(2)]
    JState = namedtuple("JState", "params")
    jtr = types.SimpleNamespace(xcfg=jxcfg, vocab=list(range(V)),
                                state=JState(jp), n_devices=1, batch_size=8,
                                multi_device=False, mesh=None,
                                dis_iter=lambda: iter(batches))
    jph = jloop.GanPhases(jtr, jcfg)
    layout = topt.FlatLayout.of(to_torch(jp))
    flat = layout.flatten(to_torch(jp)).requires_grad_(True)
    state = types.SimpleNamespace(flat=flat, layout=layout,
                                  params=lambda: layout.unflatten(state.flat))
    ttr = types.SimpleNamespace(xcfg=txcfg, vocab=list(range(V)), state=state,
                                n_devices=1, device=torch.device("cpu"),
                                dis_iter=lambda: iter(batches))
    tph = tloop.GanPhases(ttr, tcfg)
    assert tph.dis_cfg.num_attention_heads == 4
    np.testing.assert_array_equal(
        tph.dis_flat.numpy(), tph.dis_layout.flatten(
            to_torch(jph.dis_params)).numpy())
    k1, r_dis = jax.random.split(jph.rng)
    _, r_gen = jax.random.split(k1)
    keys = list(jax.random.split(r_dis, 2)) + list(jax.random.split(r_gen, 2))
    draws = iter([JaxBertDraws(k, 2, jph.dis_cfg) for k in keys])
    tph._draws = lambda: next(draws)
    dis0, gen0 = tph.dis_flat.clone(), flat.detach().clone()
    jph.dis_phase(0)
    tph.dis_phase(0)
    jph.gen_phase(0)
    tph.gen_phase(0)
    assert tph.dis_opt_state.count == 1 and tph.gen_opt_state.count == 1
    lay = tph.dis_layout
    fmask = lay.mask(lambda n: n in tph.dis_frozen)
    assert set(tph.dis_frozen) == {n for n in lay.names if "embedding" in n
                                   or n.startswith(("emb_ln", "layers.0."))}
    assert torch.equal(tph.dis_flat[fmask], dis0[fmask])
    assert not tph.dis_opt_state.mu[fmask].any()
    assert not tph.dis_opt_state.nu[fmask].any()
    for got, ref, lay_ in ((tph.dis_opt_state.mu, jph.dis_opt_state, lay),
                           (tph.gen_opt_state.mu, jph.gen_opt_state, layout)):
        np.testing.assert_allclose(
            got.numpy(), lay_.flatten(to_torch(_adam_mu(ref))).numpy(),
            rtol=2e-4, atol=1e-8)
    for got, before, ref, lay_, lr in (
            (tph.dis_flat, dis0, to_torch(jph.dis_params), lay, 1e-3),
            (flat.detach(), gen0, to_torch(jtr.state.params), layout, 1e-3)):
        diff = ((got - before) - (lay_.flatten(ref) - before)).abs()
        assert float((diff > 1e-3 * lr).float().mean()) < 1e-3
        assert float(diff.max()) <= 2 * lr
    # the head moved (under wgan-gp the class-0 bias's gradient is exactly
    # zero: the real and fake means' cotangents cancel)
    live, start = tph.dis_params(), lay.unflatten(dis0)
    for k in ("pooler_w", "pooler_b", "classifier_w"):
        assert not torch.equal(live[k], start[k]), k
    np.testing.assert_allclose(tph.pop_log_stats(), jph.pop_log_stats(),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoints, conversion and the CLI
# ---------------------------------------------------------------------------

def _pretrain(tmp_path, data, steps=2):
    from transformer_gan_torch.cli import bert_pretrain
    out = str(tmp_path / "bert")
    bert_pretrain.main([
        "--train_data_file", data, "--output_dir", out, "--vocab_file",
        PACKAGED_VOCAB, "--num_hidden_layers", "2", "--hidden_size", "24",
        "--block_size", "16", "--per_gpu_train_batch_size", "4",
        "--max_steps", str(steps), "--logging_steps", "1", "--save_steps",
        "1", "--eval_steps", "100", "--device", "cpu"])
    return os.path.join(out, f"checkpoint-{steps}")


def test_critic_config_and_graft_from_checkpoint(tmp_path):
    """The MLM checkpoint's metadata sizes the critic over the config's
    keys; the trunk comes from the checkpoint, the pooler, classifier and
    MLM head from the fresh init (seed 17); random_weights ignores it."""
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=4, train_len=60,
                        n_eval=2, eval_len=30, seed=0)
    path = _pretrain(tmp_path, data)
    cfg = training_config().merge({"DISCRIMINATOR": {"type": "bert", "BERT": {
        "model_path": path, "hidden_size": 768, "num_hidden_layers": 5,
        "intermediate_size": 3072}}, "TPU": {"compute_dtype": "float32"}})
    dcfg = tloop._bert_dis_cfg(cfg, V)
    assert (dcfg.hidden_size, dcfg.num_hidden_layers, dcfg.vocab_size) == \
        (24, 2, 311)
    params = tloop.GanPhases._init_bert(dcfg, path, False, seed=17)
    saved = tckpt.load_bert_params(path)
    fresh = tbert.init_bert_params(dcfg, seed=17)
    trunk = set(tbert.trunk_names(fresh))
    for k, v in params.items():
        assert torch.equal(v, saved[k] if k in trunk else fresh[k]), k
    assert not torch.equal(saved["pooler_w"], fresh["pooler_w"])
    with pytest.raises(ValueError, match="cannot embed"):
        tloop._bert_dis_cfg(cfg, 400)      # the checkpoint's vocab is 311
    cfg.DISCRIMINATOR.BERT.random_weights = True
    assert tloop._bert_dis_cfg(cfg, V).hidden_size == 768
    cfg.DISCRIMINATOR.BERT.random_weights = False
    cfg.DISCRIMINATOR.BERT.model_path = str(tmp_path / "missing")
    assert tloop._bert_dis_cfg(cfg, V).hidden_size == 768


def test_bert_checkpoint_converts_both_ways(tmp_path):
    """A JAX MLM checkpoint (orbax, with metadata) becomes the port's BERT
    checkpoint directory through its numpy archive, bit for bit, and sizes
    and warm-starts the port's critic; the port writes back the same
    entries."""
    from test_torch_params import write_archive
    from transformer_gan_tpu.bert import mlm as jmlm
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=4, train_len=60,
                        n_eval=2, eval_len=30, seed=1)
    jt = jmlm.MlmTrainer(data, str(tmp_path / "jax"), PACKAGED_VOCAB,
                         num_hidden_layers=2, hidden_size=24, block_size=16,
                         batch_size=4, max_steps=1, seed=3)
    jt.step = 7
    jt.save()
    archive = write_archive(str(tmp_path / "jax" / "checkpoint-7"))
    out = convert.import_bert_archive(archive, str(tmp_path / "port" /
                                                   "checkpoint-7"))
    got = tckpt.load_bert_params(out)
    ref = flat_tree(jt.params)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert tckpt.load_bert_metadata(out) == {
        "step": 7, "config": {"vocab_size": 311, "num_hidden_layers": 2,
                              "hidden_size": 24}}
    back = convert.archive_from_bert_checkpoint(out)
    arr = convert.read_archive(archive)
    assert set(back) == set(arr)
    for k, v in back.items():
        np.testing.assert_array_equal(v, arr[k], err_msg=k)
    cfg = training_config().merge({"DISCRIMINATOR": {"type": "bert", "BERT": {
        "model_path": out}}})
    dcfg = tloop._bert_dis_cfg(cfg, V)
    assert (dcfg.hidden_size, dcfg.num_hidden_layers) == (24, 2)
    warm = tloop.GanPhases._init_bert(dcfg, out, False, seed=17)
    assert torch.equal(warm["layers.1.ffn_w2"], got["layers.1.ffn_w2"])


def test_bert_gan_checkpoint_converts_both_ways(tmp_path):
    """A JAX spanbert GAN training checkpoint (the critic, its optimizer
    state inside the freeze's chain, the gen optimizer) becomes the port's
    checkpoint through its numpy archive; the port writes back the same
    entries."""
    from test_torch_params import write_archive
    from transformer_gan_tpu.train import checkpoint as jck
    from transformer_gan_tpu.train import gan_loop as jloop
    from transformer_gan_tpu.train import optim as jopt
    jcfg = _jax_cfg(_bert_phase_cfg(tmp_path, ["0"], weight_decay=0.01))
    jxcfg = jxl.XLConfig.from_cfg(jcfg, V)
    jp = jxl.init_xl_params(jxcfg, seed=0)
    opt = jopt.make_optimizer("adam", 1e-3, jopt.constant_schedule(0), 1.0)
    JState = namedtuple("JState", "params")
    jtr = types.SimpleNamespace(xcfg=jxcfg, vocab=list(range(V)),
                                state=JState(jp), n_devices=1, batch_size=8,
                                multi_device=False, mesh=None,
                                dis_iter=lambda: iter([]))
    jph = jloop.GanPhases(jtr, jcfg)
    bump = jax.tree.map(lambda x: x + 0.25 if jnp.issubdtype(
        x.dtype, jnp.floating) else x + 3, (jph.gen_opt_state,
                                           jph.dis_opt_state))
    payload = {"params": jp, "opt_state": opt.init(jp),
               "dis_params": jph.dis_params, "gen_opt_state": bump[0],
               "dis_opt_state": bump[1]}
    jck.save_checkpoint(str(tmp_path / "jax"), "checkpoint_last", payload,
                        {"train_step": 3})
    archive = write_archive(str(tmp_path / "jax" / "checkpoint_last"))
    convert.import_archive(archive, str(tmp_path / "port"))
    gan = tckpt.load_gan_payload(str(tmp_path / "port"), "checkpoint_last")
    assert gan["dis_opt_state"].count == 3
    assert float(gan["dis_opt_state"].mu.min()) == 0.25
    ref = convert.read_archive(archive)
    back = convert.archive_from_checkpoint(str(tmp_path / "port"),
                                           "checkpoint_last")
    assert set(back) == set(ref)
    for k, v in back.items():
        np.testing.assert_array_equal(v, ref[k].astype(v.dtype), err_msg=k)


def _spanbert_cfg_file(tmp_path, model_path, **train):
    """experiment_spanbert.yml cut to a tiny model and run on the CPU."""
    with open(os.path.join(ROOT, "training_config",
                           "experiment_spanbert.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"].update(num_layers=2, num_heads=2, units=16, inner_size=32)
    cfg["TRAIN"].update({"load_from_previous": "Null", "batch_size": 8,
                         "batch_chunk": 2, "max_step": 3, "log_interval": 1,
                         "eval_interval": 3, "mem_length": 8, "tgt_length": 8,
                         "warmup_step": 2, **train})
    cfg["EVALUATE"].update(batch_size=2, mem_length=8, tgt_length=8)
    cfg["DISCRIMINATOR"].update(tgt_len=16, mem_len=16, context_len=3,
                                batch_chunk=2, start_iter=0, dis_loss_freq=1,
                                gen_loss_freq=1)
    cfg["DISCRIMINATOR"]["BERT"].update(model_path=model_path,
                                        freeze_layers=["0", "1"])
    cfg["TPU"].update(compute_dtype="float32")
    path = tmp_path / f"spanbert_{len(train)}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_spanbert_trains_and_restarts(tmp_path):
    """cli.bert_pretrain, then the training CLI on the spanbert config with
    that checkpoint as the critic (both layers frozen): dis and gen phases
    from step 1, their losses logged, the trunk equal to the checkpoint's
    bitwise after the updates while the pooler and classifier weights moved
    from their fresh init, the
    GAN state in the checkpoint, and --restart keeps both counts."""
    from transformer_gan_torch.cli import train as tcli
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=12, train_len=60,
                        n_eval=3, eval_len=40, seed=0)
    bert = _pretrain(tmp_path, data)
    tr = tcli.main(["--data_dir", data, "--cfg", _spanbert_cfg_file(
        tmp_path, bert), "--work_dir", str(tmp_path / "w"), "--device",
        "cpu"])
    assert tr.train_step_num == 3
    assert tr.gan.dis_opt_state.count == 2 and tr.gan.gen_opt_state.count == 2
    with open(os.path.join(tr.work_dir, "train_rank0.log")) as f:
        log = f.read()
    assert "Loading BERT discriminator weights" in log
    lines = [l for l in log.splitlines() if "Train Step" in l]
    assert all("gen_loss=0.0000" not in l and "dis_loss=0.0000" not in l
               for l in lines[1:])
    saved = tckpt.load_bert_params(bert)
    live = tr.gan.dis_params()
    for k in tbert.trunk_names(live):
        assert torch.equal(live[k], saved[k]), k
    fresh = tbert.init_bert_params(tr.gan.dis_cfg, seed=17)
    for k in ("pooler_w", "pooler_b", "classifier_w"):   # see above
        assert not torch.equal(live[k], fresh[k]), k
    payload = tckpt.load_gan_payload(tr.work_dir, "checkpoint_last")
    assert payload["dis_opt_state"].count == 2
    assert all(torch.equal(payload["dis_params"][k], live[k]) for k in live)
    again = tcli.main(["--data_dir", data, "--cfg", _spanbert_cfg_file(
        tmp_path, bert, max_step=4), "--work_dir", tr.work_dir, "--restart",
        "--device", "cpu"])
    assert again.train_step_num == 4
    assert again.gan.dis_opt_state.count == 3
    assert again.gan.gen_opt_state.count == 3
    for k in tbert.trunk_names(live):
        assert torch.equal(again.gan.dis_params()[k], saved[k]), k
