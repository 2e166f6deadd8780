"""The port's GAN phases (RelGAN CNN discriminator) against the JAX package,
fp32 on the CPU at a tiny width (2 layers, 2 heads, d_model 16, V 310),
where the sampler and chain kernels' wrappers run their plain versions:

* the discriminator (init bit for bit, logits with and without dropout),
  the eight loss families, the temperature schedules and the gradient
  penalty;
* ``gan_losses_for_batch`` for the dis and the gen phase with the same
  random draws: a ``Draws`` subclass recomputes the JAX package's gumbel
  noise, dropout draws and penalty weights from its key, as
  ``models/gan.py`` splits it there. Losses within rtol 1e-6, every
  generator gradient within rtol 2e-4, atol 1e-7 (the JAX suite's own
  bounds for its batched recompute against its sequential oracle);
* one ``GanPhases`` dis and gen step (updated parameters) and the
  discriminator iterator;
* the training CLI on a tiny cnn config with ``--device cpu``, with a
  restart, and the GAN checkpoint payload through the numpy archive."""

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
from transformer_gan_torch import convert
from transformer_gan_torch.config import PACKAGED_VOCAB, training_config
from transformer_gan_torch.models import discriminator as tdisc
from transformer_gan_torch.models import gan as tgan
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.train import checkpoint as tckpt
from transformer_gan_torch.train import losses as tlosses
from transformer_gan_tpu.models import discriminator as jdisc
from transformer_gan_tpu.models import gan as jgan
from transformer_gan_tpu.models import xl as jxl
from transformer_gan_tpu.train import losses as jlosses

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=310,
            dropout=0.0, dropatt=0.0)
V = 310


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


def _t(tree):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in flat_tree(tree).items()}


class JaxDraws(tgan.Draws):
    """The random numbers the JAX package's ``gan_losses_for_batch`` draws
    from ``key``: per sampled chunk c the per-step uniforms of
    split(split(sample_key, chunks)[c], n) turned into gumbel noise, and per
    scored chunk the (score, gp) keys of the running split."""

    def __init__(self, key, chunks: int):
        rng, sample_rng = jax.random.split(key)
        self.sample_rngs = jax.random.split(sample_rng, chunks)
        self.chunk_rngs = []
        for _ in range(chunks):
            rng, score_rng, gp_rng = jax.random.split(rng, 3)
            self.chunk_rngs.append((score_rng, gp_rng))

    def gumbel(self, chunk, n, bsz, V):
        steps = jax.random.split(self.sample_rngs[chunk], n)
        u = jax.vmap(lambda r: jax.random.uniform(
            r, (1, bsz, V), dtype=jnp.float32)[0])(steps)
        return torch.from_numpy(np.array(-jnp.log(-jnp.log(u + 1e-20) + 1e-20)))

    def dropout_u(self, chunk, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.chunk_rngs[chunk][0], shape, dtype=jnp.float32)))

    def gp_alpha(self, chunk, bsz):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.chunk_rngs[chunk][1], (bsz, 1, 1), dtype=jnp.float32)))


# ---------------------------------------------------------------------------
# Discriminator, losses, schedules, gradient penalty
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init", ["uniform", "normal", "truncated_normal"])
def test_relgan_matches_jax(init):
    jcfg = jdisc.RelganConfig(embed_dim=16, num_rep=4, vocab_size=V, init=init)
    tcfg = tdisc.RelganConfig(embed_dim=16, num_rep=4, vocab_size=V, init=init)
    jp = jdisc.init_relgan_params(jcfg, seed=1)
    tp = tdisc.init_relgan_params(tcfg, seed=1)
    ref = flat_tree(jp)
    assert set(tp) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(tp[k].numpy(), v, err_msg=k)
    x = np.random.RandomState(0).dirichlet(np.ones(V), (6, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tdisc.relgan_logits(tp, tcfg, torch.from_numpy(x)).numpy(),
        np.asarray(jdisc.relgan_logits(jp, jcfg, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    key = jax.random.PRNGKey(4)
    u = jax.random.uniform(key, tdisc.dropout_shape(tcfg, 6), jnp.float32)
    np.testing.assert_allclose(
        tdisc.relgan_logits(tp, tcfg, torch.from_numpy(x), train=True,
                            dropout_u=torch.from_numpy(np.array(u))).numpy(),
        np.asarray(jdisc.relgan_logits(jp, jcfg, jnp.asarray(x), train=True,
                                       rng=key)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("loss_type", ["standard", "JS", "KL", "hinge", "wgan",
                                       "tv", "rsgan", "ppo"])
def test_losses_match_jax(loss_type):
    rng = np.random.RandomState(7)
    real, fake = (rng.randn(24).astype(np.float32) for _ in range(2))
    jg, jd = jlosses.get_losses(jnp.asarray(real), jnp.asarray(fake), loss_type)
    tg, td = tlosses.get_losses(torch.from_numpy(real), torch.from_numpy(fake),
                                loss_type)
    np.testing.assert_allclose(float(tg), float(jg), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("adapt", ["no", "lin", "exp", "log", "sigmoid", "quad",
                                   "sqrt"])
def test_temperature_schedules_match_jax(adapt):
    for i in (0, 1, 37, 99):
        assert tlosses.get_fixed_temperature(100.0, i, 100, adapt) == \
            pytest.approx(jlosses.get_fixed_temperature(100.0, i, 100, adapt),
                          rel=1e-12)


def test_gradient_penalty_matches_jax():
    """The penalty and its gradient in the discriminator's parameters (the
    double backward)."""
    jcfg = jdisc.RelganConfig(embed_dim=8, num_rep=4, vocab_size=V)
    tcfg = tdisc.RelganConfig(embed_dim=8, num_rep=4, vocab_size=V)
    jp = jdisc.init_relgan_params(jcfg, seed=2)
    rng = np.random.RandomState(3)
    real = np.eye(V, dtype=np.float32)[rng.randint(2, V, (4, 10))]
    fake = rng.dirichlet(np.ones(V), (4, 10)).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def jpen(p):
        return jlosses.gradient_penalty(
            lambda x: jdisc.relgan_logits(p, jcfg, x), jnp.asarray(real),
            jnp.asarray(fake), key)

    jval, jgrad = jax.jit(jax.value_and_grad(jpen))(jp)
    alpha = jax.random.uniform(key, (4, 1, 1), dtype=jnp.float32)
    tp = {k: v.requires_grad_(True) for k, v in _t(jp).items()}
    tval = tlosses.gradient_penalty(
        lambda x: tdisc.relgan_logits(tp, tcfg, x), torch.from_numpy(real),
        torch.from_numpy(fake), torch.from_numpy(np.array(alpha)))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    for k, g in flat_tree(jgrad).items():
        # the logits' input gradient does not depend on the last bias
        got = tp[k].grad if tp[k].grad is not None else torch.zeros_like(tp[k])
        np.testing.assert_allclose(got.numpy(), g, rtol=2e-4, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# gan_losses_for_batch
# ---------------------------------------------------------------------------

def _batch_setup(gk, bsz=8, tgt_len=16, chunks=2):
    jxcfg = jxl.XLConfig(cache_kv=True, use_pallas=False, **BASE)
    txcfg = txl.XLConfig(**BASE)
    jgp = jxl.init_xl_params(jxcfg, seed=0)
    common = dict(dis_type="cnn", loss_type="rsgan", tgt_len=tgt_len,
                  mem_len=16, context_len=3, sample_chunks_mem=chunks,
                  n_token=V)
    jg = jgan.GanConfig(decode_cache="chunked",
                        **{**common, **gk.get("jax", {})})
    tg = tgan.GanConfig(**{**common, **gk.get("port", {})})
    rj = jdisc.RelganConfig(embed_dim=16, num_rep=4, vocab_size=V)
    rt = tdisc.RelganConfig(embed_dim=16, num_rep=4, vocab_size=V)
    jdp = jdisc.init_relgan_params(rj, seed=1)
    data = np.random.RandomState(3).randint(2, V, (tgt_len, bsz))
    return jxcfg, txcfg, jgp, jg, tg, rj, rt, jdp, data


GEN_CASES = {
    # the chain terms: the JAX jnp chain against the port's three routes
    # (K6 and K7 wrappers and the plain loop, all plain on the CPU)
    "full_chain": ({"chain_bwd": "jnp"},
                   [{"chain_bwd": c} for c in ("auto", "kernel_recompute",
                                               "jnp")]),
    "truncate": ({"truncate_backprop": True}, [{"truncate_backprop": True}]),
    "sequential": ({"fused_sampler": "off", "chain_bwd": "off"},
                   [{"fused_sampler": "off", "chain_bwd": "off"}]),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_gen_losses_and_grads_match_jax(case):
    """The gen phase's loss and every generator gradient: the chain terms
    through the reverse chain, the truncated chain and the sequential
    oracle path."""
    jax_over, port_overs = GEN_CASES[case]
    (jxcfg, txcfg, jgp, jg, _, rj, rt, jdp, data) = _batch_setup(
        {"jax": jax_over})
    key, T = jax.random.PRNGKey(11), 0.9

    def jloss(gp):
        losses, _ = jgan.gan_losses_for_batch(gp, jdp, rj, jxcfg, jg,
                                              jnp.asarray(data), T, key,
                                              train_dis=False)
        return losses["gen_loss"]

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(jgp)
    for over in port_overs:
        tg = tgan.GanConfig(**{**_batch_setup({})[4].__dict__, **over})
        tp = {k: v.requires_grad_(True) for k, v in _t(jgp).items()}
        losses = tgan.gan_losses_for_batch(
            tp, _t(jdp), rt, txcfg, tg, torch.from_numpy(data), T,
            JaxDraws(key, tg.sample_chunks_mem), train_dis=False)
        losses["gen_loss"].backward()
        np.testing.assert_allclose(float(losses["gen_loss"].detach()),
                                   float(jval), rtol=1e-6)
        for k, g in flat_tree(jgrad).items():
            np.testing.assert_allclose(tp[k].grad.numpy(), g, rtol=2e-4,
                                       atol=1e-7, err_msg=f"{over} {k}")


@pytest.mark.parametrize("loss_type", ["rsgan", "wgan-gp"])
def test_dis_losses_and_grads_match_jax(loss_type):
    """The dis phase's loss (dropout on, the JAX draws), the gradient
    penalty and every discriminator gradient."""
    gk = {"jax": {"loss_type": loss_type}, "port": {"loss_type": loss_type}}
    (jxcfg, txcfg, jgp, jg, tg, rj, rt, jdp, data) = _batch_setup(gk)
    key, T = jax.random.PRNGKey(5), 1.0

    def jloss(dp):
        losses, _ = jgan.gan_losses_for_batch(jgp, dp, rj, jxcfg, jg,
                                              jnp.asarray(data), T, key,
                                              train_dis=True)
        return losses["dis_loss"] + losses["gp_loss"], losses

    (_, jl), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jdp)
    tdp = {k: v.requires_grad_(True) for k, v in _t(jdp).items()}
    losses = tgan.gan_losses_for_batch(
        _t(jgp), tdp, rt, txcfg, tg, torch.from_numpy(data), T,
        JaxDraws(key, tg.sample_chunks_mem), train_dis=True)
    (losses["dis_loss"] + losses["gp_loss"]).backward()
    for k in ("dis_loss", "gp_loss"):
        np.testing.assert_allclose(float(losses[k].detach()), float(jl[k]),
                                   rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for k, g in flat_tree(jgrad).items():
        np.testing.assert_allclose(tdp[k].grad.numpy(), g, rtol=2e-4,
                                   atol=1e-7, err_msg=k)


def test_gan_config_refuses_unported():
    """An unknown discriminator raises; cnn and bert pass, PPO (either
    discriminator's loss) too, and so do the rolling cache and the
    raw-hidden memory, which route the GAN onto the rolling sampler."""
    from transformer_gan_torch.config import check_gan_config
    for dis_type, loss in (("cnn", "rsgan"), ("bert", "wgan-gp"),
                           ("cnn", "ppo"), ("bert", "ppo-gp")):
        cfg = training_config()
        cfg.DISCRIMINATOR.type = dis_type
        getattr(cfg.DISCRIMINATOR, dis_type.upper()).loss_type = loss
        check_gan_config(cfg)
    cfg = training_config()
    cfg.DISCRIMINATOR.type = "rnn"
    with pytest.raises(NotImplementedError):
        check_gan_config(cfg)
    for dis_type, key, value in (("cnn", "gan_decode_cache", "rolling"),
                                 ("bert", "cache_kv", False)):
        cfg = training_config()
        cfg.DISCRIMINATOR.type = dis_type
        setattr(cfg.TPU, key, value)
        check_gan_config(cfg)
        gcfg = tgan.GanConfig.from_cfg(cfg, V)
        xcfg = txl.XLConfig.from_cfg(cfg, V)
        assert not (xcfg.cache_kv and gcfg.decode_cache != "rolling")


# ---------------------------------------------------------------------------
# The GRU discriminator (inventory: no GAN route reaches it)
# ---------------------------------------------------------------------------

def test_gru_matches_jax():
    """init_gru_params bit for bit, gru_logits without and with dropout
    (JAX's draws) against the JAX package's, rtol 1e-5 / atol 1e-6."""
    jcfg = jdisc.GruConfig(embedding_dim=12, hidden_dim=10, feature_dim=8)
    tcfg = tdisc.GruConfig(embedding_dim=12, hidden_dim=10, feature_dim=8)
    jp = jdisc.init_gru_params(jcfg, seed=3)
    tp = tdisc.init_gru_params(tcfg, seed=3)
    ref = flat_tree(jp)
    assert set(tp) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(tp[k].numpy(), v, err_msg=k)
    ids = np.random.RandomState(0).randint(0, V, (4, 9))
    np.testing.assert_allclose(
        tdisc.gru_logits(tp, tcfg, torch.from_numpy(ids)).numpy(),
        np.asarray(jdisc.gru_logits(jp, jcfg, jnp.asarray(ids))),
        rtol=1e-5, atol=1e-6)
    key = jax.random.PRNGKey(2)
    u = jax.random.uniform(key, (4, 8), jnp.float32)
    np.testing.assert_allclose(
        tdisc.gru_logits(tp, tcfg, torch.from_numpy(ids), train=True,
                         dropout_u=torch.from_numpy(np.array(u))).numpy(),
        np.asarray(jdisc.gru_logits(jp, jcfg, jnp.asarray(ids), train=True,
                                    rng=key)), rtol=1e-5, atol=1e-6)


def test_gru_params_convert_both_ways(tmp_path):
    """The GRU's parameters through the numpy archive of a JAX checkpoint
    (``dis_params/layers/i/w_ih`` ...) into the port's names and back into
    the JAX tree, bit for bit."""
    from test_torch_params import write_archive
    from transformer_gan_tpu.train import checkpoint as jck
    jcfg = jdisc.GruConfig(embedding_dim=12, hidden_dim=10, feature_dim=8)
    jp = jdisc.init_gru_params(jcfg, seed=4)
    jck.save_checkpoint(str(tmp_path), "checkpoint_last", {"dis_params": jp})
    arrays = convert.read_archive(write_archive(str(tmp_path
                                                    / "checkpoint_last")))
    got = convert.tensors_from_archive(arrays, "dis_params")
    assert set(got) == set(tdisc.init_gru_params(tdisc.GruConfig(), 0))
    for k, v in flat_tree(jp).items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    back = convert.params_to_jax(got)
    assert len(back["layers"]) == 4
    for k, v in flat_tree(back).items():
        np.testing.assert_array_equal(v, flat_tree(jp)[k], err_msg=k)


# ---------------------------------------------------------------------------
# GanPhases, the dis iterator, the CLI, the checkpoint payload
# ---------------------------------------------------------------------------

PHASE_CFG = {
    "MODEL": {"num_layers": 2, "num_heads": 2, "units": 16, "inner_size": 32,
              "dropout": 0.0, "attention_dropout": 0.0},
    "TRAIN": {"batch_size": 8, "max_step": 100, "clip": 1.0},
    "DISCRIMINATOR": {"type": "cnn", "start_iter": 0, "dis_steps": 1,
                      "freeze_discriminator": False, "tgt_len": 16,
                      "mem_len": 16, "context_len": 3, "batch_chunk": 2,
                      "sample_chunks_mem": 2, "gen_lr": 1e-3, "dis_lr": 1e-3,
                      "CNN": {"embed_dim": 16, "num_rep": 4,
                              "learning_rate": 1e-3, "loss_type": "rsgan"}},
    "TPU": {"compute_dtype": "float32", "use_pallas_attention": False,
            "rng_impl": "threefry2x32"},
}


def _jax_cfg(over):
    from transformer_gan_tpu.config import get_default_cfg_training
    cfg = get_default_cfg_training()
    cfg.defrost()

    def apply(node, d):
        for k, v in d.items():
            if isinstance(v, dict):
                apply(getattr(node, k), v)
            else:
                setattr(node, k, v)
    apply(cfg, over)
    cfg.freeze()
    return cfg


def _adam_mu(state):
    """The first moment of the Adam transform inside a JAX optax state."""
    import optax
    if isinstance(state, optax.ScaleByAdamState):
        return state.mu
    if isinstance(state, tuple):
        for s in state:
            mu = _adam_mu(s)
            if mu is not None:
                return mu
    return None


def test_gan_phases_step_matches_jax():
    """One dis update and one gen update of GanPhases (two micro-batches
    each, the same real batches and draws). Adam's first moment after the
    step, (1 - b1) times the clipped phase gradient, within the gradient
    bounds of ``test_gen_losses_and_grads_match_jax`` (rtol 2e-4, atol 1e-7
    on the gradient): it holds the micro-batch scale and the loss factors.
    The updated parameters: Adam's first step moves a weight by lr * g /
    (|g| + 1e-8), lr = 1e-3, so the moves agree within 1e-6 except where a
    gradient vanishes within fp32 noise and its sign is a coin toss (at
    most 0.1% of the weights, each still within 2 lr)."""
    from transformer_gan_torch.train import gan_loop as tloop
    from transformer_gan_torch.train import optim as topt
    from transformer_gan_tpu.train import gan_loop as jloop
    jcfg, tcfg = _jax_cfg(PHASE_CFG), training_config().merge(PHASE_CFG)
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
    layout = topt.FlatLayout.of(_t(jp))
    flat = layout.flatten(_t(jp)).requires_grad_(True)
    state = types.SimpleNamespace(flat=flat, layout=layout,
                                  params=lambda: layout.unflatten(state.flat))
    ttr = types.SimpleNamespace(xcfg=txcfg, vocab=list(range(V)), state=state,
                                n_devices=1, device=torch.device("cpu"),
                                dis_iter=lambda: iter(batches))
    tph = tloop.GanPhases(ttr, tcfg)
    np.testing.assert_array_equal(
        tph.dis_flat.numpy(),
        tph.dis_layout.flatten(_t(jph.dis_params)).numpy())
    # the JAX phases' keys, in the order the port draws micro-batches
    k1, r_dis = jax.random.split(jph.rng)
    _, r_gen = jax.random.split(k1)
    keys = list(jax.random.split(r_dis, 2)) + list(jax.random.split(r_gen, 2))
    draws = iter([JaxDraws(k, 2) for k in keys])
    tph._draws = lambda: next(draws)
    dis0, gen0 = tph.dis_flat.clone(), flat.detach().clone()
    jph.dis_phase(0)
    tph.dis_phase(0)
    jph.gen_phase(0)
    tph.gen_phase(0)
    assert tph.dis_opt_state.count == 1 and tph.gen_opt_state.count == 1
    for got, ref, lay in ((tph.dis_opt_state.mu, jph.dis_opt_state,
                           tph.dis_layout),
                          (tph.gen_opt_state.mu, jph.gen_opt_state, layout)):
        np.testing.assert_allclose(
            got.numpy(), lay.flatten(_t(_adam_mu(ref))).numpy(),
            rtol=2e-4, atol=1e-8)
    for got, before, ref, lay in (
            (tph.dis_flat, dis0, _t(jph.dis_params), tph.dis_layout),
            (flat.detach(), gen0, _t(jtr.state.params), layout)):
        diff = ((got - before) - (lay.flatten(ref) - before)).abs()
        assert float((diff > 1e-6).float().mean()) < 1e-3
        assert float(diff.max()) <= 2e-3
    g, d = tph.pop_log_stats()
    jg_, jd_ = jph.pop_log_stats()
    np.testing.assert_allclose([g, d], [jg_, jd_], rtol=1e-5)


def test_dis_iterator_matches_jax(tmp_path):
    from transformer_gan_torch.data.dataset import MusicDataset as TData
    from transformer_gan_tpu.data.dataset import MusicDataset as JData
    write_random_corpus(str(tmp_path), PACKAGED_VOCAB, n_train=12,
                        train_len=60, n_eval=3, eval_len=40, seed=1)
    jit = JData(str(tmp_path), _jax_cfg({})).get_dis_iterator(
        8, 16, seed=5)()
    tit = TData(str(tmp_path), training_config()).get_dis_iterator(
        8, 16, seed=5)()
    for _ in range(5):
        (jd, jn), (td, tn) = next(jit), next(tit)
        np.testing.assert_array_equal(td, jd)
        assert tn == jn


def _cnn_cfg_file(tmp_path, **train):
    """experiment_cnn.yml cut to a tiny model and run on the CPU."""
    with open(os.path.join(ROOT, "training_config", "experiment_cnn.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"].update(num_layers=2, num_heads=2, units=16, inner_size=32)
    cfg["TRAIN"].update({"load_from_previous": "Null", "batch_size": 8,
                         "batch_chunk": 2, "max_step": 4, "log_interval": 2,
                         "eval_interval": 2, "mem_length": 8, "tgt_length": 8,
                         "warmup_step": 2, **train})
    cfg["EVALUATE"].update(batch_size=2, mem_length=8, tgt_length=8)
    cfg["DISCRIMINATOR"].update(tgt_len=16, mem_len=16, context_len=3,
                                dis_steps=2, dis_loss_freq=1, gen_loss_freq=2,
                                CNN={"embed_dim": 8, "num_rep": 4})
    cfg["TPU"].update(compute_dtype="float32")
    path = tmp_path / f"cnn_{len(train)}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_gan_trains_and_restarts(tmp_path):
    """The training CLI on the cnn config: GAN phases from step 1 (dis every
    step, gen every second), their losses on the log line, the GAN state in
    the checkpoints, and --restart picks it up."""
    from transformer_gan_torch.cli import train as tcli
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=12, train_len=60,
                        n_eval=3, eval_len=40, seed=0)
    tr = tcli.main(["--data_dir", data, "--cfg", _cnn_cfg_file(tmp_path),
                    "--work_dir", str(tmp_path / "w"), "--device", "cpu"])
    run = tr.work_dir
    assert tr.train_step_num == 4
    # phases after the MLE step of steps 1..3: dis 3 x 2 updates, gen at 2
    assert tr.gan.dis_opt_state.count == 6 and tr.gan.gen_opt_state.count == 1
    with open(os.path.join(run, "train_rank0.log")) as f:
        log = f.read()
    assert "dis_phase step 1" in log and "gen_phase step 2" in log
    lines = [l for l in log.splitlines() if "Train Step" in l]
    assert all("gen_loss=0.0000" not in l for l in lines[1:])
    payload = tckpt.load_gan_payload(run, "checkpoint_last")
    assert payload["dis_opt_state"].count == 6
    live = tr.gan.dis_params()
    assert all(torch.equal(payload["dis_params"][k], live[k]) for k in live)
    resumed = tcli.main(["--data_dir", data, "--cfg",
                         _cnn_cfg_file(tmp_path, max_step=6), "--work_dir", run,
                         "--restart", "--device", "cpu"])
    assert resumed.train_step_num == 6
    assert resumed.gan.dis_opt_state.count == 6 + 4
    assert resumed.gan.gen_opt_state.count == 1 + 1


@pytest.mark.parametrize("tpu", [{"cache_kv": False},
                                 {"gan_decode_cache": "rolling"}])
def test_cli_gan_on_the_rolling_sampler(tmp_path, monkeypatch, tpu):
    """The training CLI on the cnn config under raw-hidden memory and under
    the rolling decode cache: every dis and gen phase samples on the rolling
    ``gen_scan``, and the fused sampler is never called."""
    from transformer_gan_torch.cli import train as tcli
    calls = {"gen_scan": 0}
    gen_scan = tgan.gen_scan

    def counted(*a, **k):
        calls["gen_scan"] += 1
        return gen_scan(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the fused sampler ran on the rolling path")

    monkeypatch.setattr(tgan, "gen_scan", counted)
    monkeypatch.setattr(tgan, "_sample_fake_chunks_fused", refuse)
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=12, train_len=60,
                        n_eval=3, eval_len=40, seed=0)
    path = _cnn_cfg_file(tmp_path, max_step=3)
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["TPU"].update(tpu)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    tr = tcli.main(["--data_dir", data, "--cfg", path, "--work_dir",
                    str(tmp_path / "w"), "--device", "cpu"])
    assert tr.train_step_num == 3
    assert tr.gan.dis_opt_state.count == 4 and tr.gan.gen_opt_state.count == 1
    assert tr.state.mems[0].hids.dim() == (6 if tpu.get("cache_kv", True)
                                           else 4)
    # one gen_scan per micro-batch (DISCRIMINATOR.batch_chunk 1,
    # sample_chunks_mem 1): dis 2 phases x 2 updates, gen 1
    assert calls["gen_scan"] == 4 + 1


def test_gan_checkpoint_converts_both_ways(tmp_path):
    """A JAX GAN training checkpoint (params, fused state, discriminator,
    the gen / dis optax chains) becomes the port's checkpoint through its
    numpy archive; the port writes back the same entries."""
    from test_torch_params import write_archive
    from transformer_gan_tpu.train import checkpoint as jck
    from transformer_gan_tpu.train import gan_loop as jloop
    from transformer_gan_tpu.train import optim as jopt
    jcfg = _jax_cfg(PHASE_CFG)
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
    meta = {"train_step": 3, "best_val_loss": 2.5, "vocab": ["<S>", "<PAD>"]}
    jck.save_checkpoint(str(tmp_path / "jax"), "checkpoint_last", payload, meta)
    archive = write_archive(str(tmp_path / "jax" / "checkpoint_last"))
    convert.import_archive(archive, str(tmp_path / "port"))
    gan = tckpt.load_gan_payload(str(tmp_path / "port"), "checkpoint_last")
    assert gan["gen_opt_state"].count == 3 and gan["dis_opt_state"].count == 3
    ref = convert.read_archive(archive)
    back = convert.archive_from_checkpoint(str(tmp_path / "port"),
                                           "checkpoint_last")
    assert set(back) == set(ref)
    for k, v in back.items():
        np.testing.assert_array_equal(v, ref[k].astype(v.dtype), err_msg=k)
