"""PPO in the port's GAN phases against the JAX package, fp32 on the CPU at
a tiny width (generator: 2 layers, 2 heads, d_model 16, V 310; BERT
critic and dis_D: 2 layers, hidden 24, 4 heads; RelGAN: embed 16), the
sampler and chain kernels' wrappers on their plain versions:

* ``ppo_surrogate`` with a main discriminator scoring 1 and 4 times a row
  (the RelGAN's tiling), with the BERT and the CNN dis_D; ``compute_P0``;
  ``classifier_loss_for_batch`` on the JAX sampler's own draws (its
  ``sample_fake_chunks`` patched to take a fixed key); the PPO branch of
  ``gan_losses_for_batch`` with P0 given and re-snapshotted. Values within
  1e-6, gradients within the bounds of ``test_torch_gan.py`` (rtol 2e-4,
  atol 1e-7);
* ``GanPhases`` under PPO with both dis_D types (the BERT critic with a
  BERT dis_D under ppo, the RelGAN with a CNN dis_D under ppo-gp): a dis
  update, then gen phases on, off and on ``dis_D_update_D0_freq``, each
  with its classifier update first. Adam's first moments of the critic,
  dis_D and the generator, leaf by leaf within 5e-5 relative (the card
  check's rule, ``kernel_check.GAN_REF_TOL``), and P0 within 1e-6;
  P0 fixed off frequency, re-snapshotted on it and after a restart;
  dis_D trains the leaves the critic freezes;
* dis_D grafted from an MLM checkpoint (the trunk only), a JAX PPO
  checkpoint through the numpy archive and back, the training CLI under
  PPO with a restart."""

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
from test_torch_bert import TINY, flat_tree, to_torch
from test_torch_gan import BASE, PHASE_CFG, JaxDraws, _adam_mu, _jax_cfg
from test_torch_gan_bert import JaxBertDraws, _pretrain
from transformer_gan_torch import convert
from transformer_gan_torch import kernel_check as kc
from transformer_gan_torch.config import PACKAGED_VOCAB, training_config
from transformer_gan_torch.models import bert as tbert
from transformer_gan_torch.models import discriminator as tdisc
from transformer_gan_torch.models import gan as tgan
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.train import checkpoint as tckpt
from transformer_gan_torch.train import gan_loop as tloop
from transformer_gan_torch.train import optim as topt
from transformer_gan_tpu.models import bert as jbert
from transformer_gan_tpu.models import discriminator as jdisc
from transformer_gan_tpu.models import gan as jgan
from transformer_gan_tpu.models import xl as jxl

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 310
CNN = dict(embed_dim=16, num_rep=1, vocab_size=V)


def _dis_D(kind: str, seed: int = 1):
    """(JAX cfg, port cfg, JAX params) of a tiny dis_D."""
    if kind == "bert":
        jcfg, tcfg = jbert.BertConfig(**TINY), tbert.BertConfig(**TINY)
        return jcfg, tcfg, jbert.init_bert_params(jcfg, seed=seed)
    jcfg, tcfg = jdisc.RelganConfig(**CNN), tdisc.RelganConfig(**CNN)
    return jcfg, tcfg, jdisc.init_relgan_params(jcfg, seed=seed)


def _gcfgs(kind: str, **kw):
    common = dict(dis_type="bert", loss_type="ppo", tgt_len=16, mem_len=16,
                  context_len=3, sample_chunks_mem=2, n_token=V, ppo=True,
                  ppo_dis_type=kind, clip_param=0.2, **kw)
    return (jgan.GanConfig(decode_cache="chunked", chain_bwd="jnp", **common),
            tgan.GanConfig(**common))


def _close(got, ref, rtol=1e-6, atol=1e-7, **kw):
    np.testing.assert_allclose(np.asarray(got.detach()) if isinstance(
        got, torch.Tensor) else got, np.asarray(ref), rtol=rtol, atol=atol,
        **kw)


@pytest.mark.parametrize("kind,num_rep", [("bert", 1), ("bert", 4),
                                          ("cnn", 1), ("cnn", 4)])
def test_ppo_surrogate_matches_jax(kind, num_rep):
    """The clipped target for fakes whose odds sit inside and outside the
    clip range, with d_out_fake of both signs and num_rep scores a row;
    its gradients in d_out_fake and the soft fakes (through the CNN dis_D;
    the BERT dis_D takes the argmax, which passes none)."""
    jcfg, tcfg, jp = _dis_D(kind)
    jg, tg = _gcfgs(kind)
    rng = np.random.RandomState(5)
    bsz = 6
    fake = rng.dirichlet(np.ones(V) * 0.1, (8, bsz)).astype(np.float32)
    d_fake = rng.randn(bsz * num_rep).astype(np.float32)
    P0 = np.exp(rng.randn(bsz)).astype(np.float32)
    w = rng.randn(bsz * num_rep).astype(np.float32)

    def jf(f, d):
        return jnp.sum(jgan.ppo_surrogate(jp, jcfg, jg, f, d,
                                          jnp.asarray(P0)) * w)

    ref = jgan.ppo_surrogate(jp, jcfg, jg, jnp.asarray(fake),
                             jnp.asarray(d_fake), jnp.asarray(P0))
    jgf, jgd = jax.grad(jf, argnums=(0, 1))(jnp.asarray(fake),
                                            jnp.asarray(d_fake))
    f = torch.from_numpy(fake).requires_grad_(True)
    d = torch.from_numpy(d_fake).requires_grad_(True)
    got = tgan.ppo_surrogate(to_torch(jp), tcfg, tg, f, d,
                             torch.from_numpy(P0))
    (got * torch.from_numpy(w)).sum().backward()
    _close(got, ref)
    _close(d.grad, jgd)
    _close(f.grad if f.grad is not None else torch.zeros_like(f), jgf,
           rtol=2e-4, atol=1e-7)
    # both branches of the clip are taken
    D1 = torch.sigmoid(tgan.dis_D_forward(to_torch(jp), tcfg, tg, f))
    ratio = (1 - D1) / (D1 * torch.from_numpy(P0))
    assert bool((ratio > 1.2).any()) and bool((ratio < 0.8).any())


@pytest.mark.parametrize("kind", ["bert", "cnn"])
def test_compute_P0_and_dis_D_forward_match_jax(kind):
    """dis_D's scores of ids and of one-hots, and the P0 snapshot."""
    jcfg, tcfg, jp = _dis_D(kind)
    jg, tg = _gcfgs(kind)
    rng = np.random.RandomState(6)
    ids = rng.randint(2, V, (8, 5))
    fake = rng.dirichlet(np.ones(V) * 0.1, (8, 5)).astype(np.float32)
    tp = to_torch(jp)
    for x in (ids, fake):
        _close(tgan.dis_D_forward(tp, tcfg, tg, torch.from_numpy(x)),
               jgan.dis_D_forward(jp, jcfg, jg, jnp.asarray(x)), rtol=1e-5,
               atol=1e-6)
    _close(tgan.compute_P0(tp, tcfg, tg, torch.from_numpy(fake)),
           jgan.compute_P0(jp, jcfg, jg, jnp.asarray(fake)))


def _generator(seed=0):
    jxcfg = jxl.XLConfig(cache_kv=True, use_pallas=False, **BASE)
    jp = jxl.init_xl_params(jxcfg, seed=seed, base_init=("normal", 0.1))
    return jxcfg, txl.XLConfig(**BASE), jp


@pytest.mark.parametrize("kind", ["bert", "cnn"])
def test_classifier_loss_for_batch_matches_jax(kind, monkeypatch):
    """dis_D's BCE over both chunks of a batch and every dis_D gradient,
    the JAX side sampling from a fixed key that the port's draws
    reproduce."""
    jxcfg, txcfg, jgp = _generator()
    jcfg, tcfg, jdp = _dis_D(kind, seed=2)
    jg, tg = _gcfgs(kind, batch_chunk=2)
    data = np.random.RandomState(3).randint(2, V, (16, 6))
    key = jax.random.PRNGKey(21)
    original = jgan.sample_fake_chunks

    def fixed_key(gen_params, xcfg, gcfg, data, temperature, rng, **kw):
        return original(gen_params, xcfg, gcfg, data, temperature, key, **kw)

    monkeypatch.setattr(jgan, "sample_fake_chunks", fixed_key)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jgan.classifier_loss_for_batch(
            jgp, p, jcfg, jxcfg, jg, jnp.asarray(data), 0.9,
            jax.random.PRNGKey(0))))(jdp)

    class Draws(JaxDraws):
        """The sampler's noise from ``key`` itself (the JAX function
        splits off its sample key before sampling; the patch hands the
        sampler ``key``)."""

        def __init__(self):
            self.sample_rngs = jax.random.split(key, 2)

    tdp = to_torch(jdp, grad=True)
    loss = tgan.classifier_loss_for_batch(to_torch(jgp), tdp, tcfg, txcfg, tg,
                                          torch.from_numpy(data), 0.9, Draws())
    loss.backward()
    _close(loss, jloss)
    for k, g in flat_tree(jgrad).items():
        got = tdp[k].grad if tdp[k].grad is not None else torch.zeros_like(
            tdp[k])
        _close(got, g, rtol=2e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kind,update_P0", [("bert", True), ("bert", False),
                                            ("cnn", True)])
def test_ppo_gan_losses_for_batch_match_jax(kind, update_P0):
    """The gen phase's PPO branch through the BERT critic: gen_loss, P0
    (given, or re-snapshotted from each chunk) and every generator
    gradient (through the CNN dis_D's ratio as well)."""
    jxcfg, txcfg, jgp = _generator()
    jcfg, tcfg, jcp = _dis_D("bert", seed=2)
    Dj, Dt, jdp = _dis_D(kind, seed=3)
    jg, tg = _gcfgs(kind)
    data = np.random.RandomState(4).randint(2, V, (16, 6))
    P0 = np.exp(np.random.RandomState(5).randn(6)).astype(np.float32)
    key = jax.random.PRNGKey(13)

    def jloss(gp):
        losses, newP0 = jgan.gan_losses_for_batch(
            gp, jcp, jcfg, jxcfg, jg, jnp.asarray(data), 0.9, key,
            train_dis=False, disD_params=jdp, disD_cfg=Dj,
            P0=jnp.asarray(P0), update_P0=update_P0)
        return losses["gen_loss"], newP0

    (jl, jP0), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jgp)
    tgp = to_torch(jgp, grad=True)
    losses = tgan.gan_losses_for_batch(
        tgp, to_torch(jcp), tcfg, txcfg, tg, torch.from_numpy(data), 0.9,
        JaxDraws(key, 2), train_dis=False, disD_params=to_torch(jdp),
        disD_cfg=Dt, P0=torch.from_numpy(P0), update_P0=update_P0)
    losses["gen_loss"].backward()
    _close(losses["gen_loss"], jl)
    _close(losses["P0"], jP0)
    if not update_P0:
        assert np.array_equal(losses["P0"].numpy(), P0)
    for k, g in flat_tree(jgrad).items():
        got = tgp[k].grad if tgp[k].grad is not None else torch.zeros_like(
            tgp[k])
        _close(got, g, rtol=2e-4, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# GanPhases under PPO
# ---------------------------------------------------------------------------

def _ppo_cfg(tmp_path, kind: str, **ppo):
    """PHASE_CFG with the BERT critic and a BERT dis_D under ppo, or the
    RelGAN (4 scores a row) and a CNN dis_D under ppo-gp."""
    disc = dict(PHASE_CFG["DISCRIMINATOR"])
    if kind == "bert":
        disc.update(type="bert", BERT={
            "hidden_size": 24, "num_hidden_layers": 2,
            "num_attention_heads": 4, "intermediate_size": 48,
            "loss_type": "ppo", "learning_rate": 1e-3,
            "model_path": str(tmp_path / "missing"), "freeze_layers": ["0"]})
    else:
        disc["CNN"] = {**disc["CNN"], "loss_type": "ppo-gp"}
    return {**PHASE_CFG, "DISCRIMINATOR": disc,
            "PPO": {"dis_D_type": kind, "dis_D_update_D0_freq": 2,
                    "dis_D_lr": 1e-3, "clip_param": 0.2, **ppo}}


def _phases(over, batches):
    """The JAX and the port's GanPhases on the same generator, and the
    port's flat generator vector."""
    from transformer_gan_tpu.train import gan_loop as jloop
    jcfg, tcfg = _jax_cfg(over), training_config().merge(over)
    jxcfg = jxl.XLConfig.from_cfg(jcfg, V)
    txcfg = txl.XLConfig.from_cfg(tcfg, V)
    jp = jxl.init_xl_params(jxcfg, seed=0, base_init=("normal", 0.1))
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
    return jph, jtr, tloop.GanPhases(ttr, tcfg), ttr, tcfg


def _leaf_err(got, ref_tree, layout) -> float:
    """The worst leaf's relative Frobenius error (leaves of at least 1e-6
    of the whole; the card check's rule)."""
    return kc._grad_errs(got, layout.flatten(to_torch(ref_tree)), layout,
                         kc.GAN_REF_TOL["leaf_floor"])["grad_leaf_max_rel_err"]


@pytest.mark.parametrize("kind", ["bert", "cnn"])
def test_gan_phases_ppo_match_jax(tmp_path, kind, monkeypatch):
    over = _ppo_cfg(tmp_path, kind)
    rng = np.random.RandomState(2)
    batches = [(rng.randint(2, V, (16, 8)), 128) for _ in range(6)]
    jph, jtr, tph, ttr, tcfg = _phases(over, batches)
    np.testing.assert_array_equal(
        tph.disD_flat.numpy(),
        tph.disD_layout.flatten(to_torch(jph.disD_params)).numpy())
    assert tph.disD_opt.trainable is None and tph.P0.shape == (4,)
    # the JAX phases' keys in the order the port draws micro-batches: the
    # dis update, then per gen phase the classifier's and the gen update's
    rngs, rest = [], jph.rng
    for _ in range(7):
        rest, r = jax.random.split(rest)
        rngs.append(r)
    keys = [k for r in rngs for k in jax.random.split(r, 2)]
    # the BERT critic's dropout in the dis update from the JAX keys too
    draws = iter([JaxBertDraws(k, 2, jph.dis_cfg) if kind == "bert"
                  else JaxDraws(k, 2) for k in keys])
    tph._draws = lambda: next(draws)
    snaps = []
    real = tgan.compute_P0
    monkeypatch.setattr(tgan, "compute_P0",
                        lambda *a: snaps.append(1) or real(*a))
    disD0 = tph.disD_flat.clone()
    jph.dis_phase(0)
    tph.dis_phase(0)
    assert _leaf_err(tph.dis_opt_state.mu, _adam_mu(jph.dis_opt_state),
                     tph.dis_layout) <= kc.GAN_REF_TOL["grad_leaf_rel"]
    np.testing.assert_allclose(tph.pop_log_stats(), jph.pop_log_stats(),
                               rtol=1e-5)
    # the critic's last bias has a gradient of exactly 0 under ppo (its
    # cotangents, W / n - 1 / n, sum to 0), so Adam moves it by +-lr on the
    # sign of rounding residue: the gen phases start from JAX's critic
    with torch.no_grad():
        tph.dis_flat.copy_(tph.dis_layout.flatten(to_torch(jph.dis_params)))
    P0s = []
    for step in (0, 1, 2):
        snaps.clear()
        jph.gen_phase(step)
        tph.gen_phase(step)
        # a snapshot a chunk, 2 micro-batches of 2 chunks, on frequency
        assert len(snaps) == (0 if step == 1 else 4), step
        _close(tph.P0, jph.P0, rtol=1e-6, atol=1e-6)
        P0s.append(tph.P0.clone())
        for got, ref, lay in (
                (tph.gen_opt_state.mu, _adam_mu(jph.gen_opt_state),
                 ttr.state.layout),
                (tph.disD_opt_state.mu, _adam_mu(jph.disD_opt_state),
                 tph.disD_layout)):
            assert _leaf_err(got, ref, lay) <= kc.GAN_REF_TOL[
                "grad_leaf_rel"], step
        assert tph.disD_opt_state.count == step + 1
        np.testing.assert_allclose(tph.pop_log_stats(), jph.pop_log_stats(),
                                   rtol=1e-5)
    assert torch.equal(P0s[0], P0s[1]) and not torch.equal(P0s[1], P0s[2])
    # dis_D trains every leaf its loss reaches, the ones the critic freezes
    # included (no trainable mask)
    moved = {n for n, a, b in zip(tph.disD_layout.names,
                                  tph.disD_layout.unflatten(tph.disD_flat).values(),
                                  tph.disD_layout.unflatten(disD0).values())
             if not torch.equal(a, b)}
    if kind == "bert":
        frozen = tloop._bert_frozen(tph.disD_layout.names, ["0"], False)
        assert frozen and set(frozen) <= moved
        assert moved == {n for n in tph.disD_layout.names
                         if not n.startswith("mlm_")}
    else:
        assert moved == set(tph.disD_layout.names)
    # a restart: dis_D and its optimizer come back, P0 does not, and the
    # first gen phase re-snapshots it off frequency
    again = tloop.GanPhases(ttr, tcfg)
    again.restore(tph.ckpt_payload())
    assert torch.equal(again.disD_flat, tph.disD_flat)
    assert again.disD_opt_state.count == 3 and not again.P0_initialized
    snaps.clear()
    again.gen_phase(3)
    assert len(snaps) == 4 and again.P0_initialized
    snaps.clear()
    tph._draws = again._draws
    tph.gen_phase(3)
    assert not snaps and torch.equal(tph.P0, P0s[2])


def test_dis_D_grafts_the_trunk_only(tmp_path):
    """With an MLM checkpoint, the BERT dis_D (seed 23) takes its trunk and
    keeps its own fresh pooler, classifier and MLM head: the JAX package
    restores every matching leaf, the checkpoint's head included, where
    the reference grafts the trunk into a fresh classifier."""
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=4, train_len=60,
                        n_eval=2, eval_len=30, seed=0)
    path = _pretrain(tmp_path, data)
    over = _ppo_cfg(tmp_path, "bert")
    # the pretrainer's heads and intermediate size (its metadata records
    # the vocab, the layers and the hidden size)
    over["DISCRIMINATOR"]["BERT"] = {**over["DISCRIMINATOR"]["BERT"],
                                     "model_path": path,
                                     "num_attention_heads": 12,
                                     "intermediate_size": 3072}
    rng = np.random.RandomState(2)
    batches = [(rng.randint(2, V, (16, 8)), 128)]
    tcfg = training_config().merge(over)
    layout = topt.FlatLayout.of(txl.init_xl_params(txl.XLConfig.from_cfg(
        tcfg, V)))
    state = types.SimpleNamespace(flat=torch.zeros(layout.size), layout=layout)
    ttr = types.SimpleNamespace(xcfg=txl.XLConfig.from_cfg(tcfg, V),
                                vocab=list(range(V)), state=state,
                                n_devices=1, device=torch.device("cpu"),
                                dis_iter=lambda: iter(batches))
    tph = tloop.GanPhases(ttr, tcfg)
    saved = tckpt.load_bert_params(path)
    fresh = tbert.init_bert_params(tph.disD_cfg, seed=23)
    live = tph.disD_params()
    trunk = set(tbert.trunk_names(live))
    for k, v in live.items():
        assert torch.equal(v, saved[k] if k in trunk else fresh[k]), k
    assert not torch.equal(saved["pooler_w"], fresh["pooler_w"])
    # the critic takes the same trunk, its own head (seed 17)
    assert all(torch.equal(tph.dis_params()[k], live[k]) for k in trunk)


def test_ppo_checkpoint_converts_both_ways(tmp_path):
    """A JAX PPO checkpoint (the critic, dis_D, their optimizer states and
    the generator's) becomes the port's checkpoint through its numpy
    archive, and the port writes back the same entries, bit for bit."""
    from test_torch_params import write_archive
    from transformer_gan_tpu.train import checkpoint as jck
    from transformer_gan_tpu.train import gan_loop as jloop
    from transformer_gan_tpu.train import optim as jopt
    jcfg = _jax_cfg(_ppo_cfg(tmp_path, "bert"))
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
                                           jph.dis_opt_state,
                                           jph.disD_opt_state))
    payload = {"params": jp, "opt_state": opt.init(jp),
               "dis_params": jph.dis_params, "gen_opt_state": bump[0],
               "dis_opt_state": bump[1], "disD_params": jph.disD_params,
               "disD_opt_state": bump[2]}
    jck.save_checkpoint(str(tmp_path / "jax"), "checkpoint_last", payload,
                        {"train_step": 3})
    archive = write_archive(str(tmp_path / "jax" / "checkpoint_last"))
    convert.import_archive(archive, str(tmp_path / "port"))
    gan = tckpt.load_gan_payload(str(tmp_path / "port"), "checkpoint_last")
    assert gan["disD_opt_state"].count == 3
    assert float(gan["disD_opt_state"].mu.min()) == 0.25
    assert gan["disD_opt_state"].lr_scale == 1.0
    for k, v in flat_tree(jph.disD_params).items():
        np.testing.assert_array_equal(gan["disD_params"][k].numpy(), v)
    ref = convert.read_archive(archive)
    back = convert.archive_from_checkpoint(str(tmp_path / "port"),
                                           "checkpoint_last")
    assert set(back) == set(ref)
    assert any(k.startswith("disD_opt_state/1/mu/") for k in back)
    for k, v in back.items():
        np.testing.assert_array_equal(v, ref[k].astype(v.dtype), err_msg=k)


def _ppo_cli_cfg(tmp_path, **train):
    """experiment_spanbert.yml cut to a tiny model under ppo (the critic
    and dis_D from random weights), run on the CPU."""
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
    cfg["DISCRIMINATOR"]["BERT"].update(
        loss_type="ppo", random_weights=True, hidden_size=24,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=48)
    cfg["PPO"] = {"dis_D_update_D0_freq": 2}
    cfg["TPU"].update(compute_dtype="float32")
    path = tmp_path / f"ppo_{len(train)}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_ppo_trains_and_restarts(tmp_path):
    """The training CLI under ppo: dis, classifier and gen updates from
    step 1, the losses logged, dis_D in the checkpoint; --restart brings
    dis_D and its optimizer back and takes one more of each."""
    from transformer_gan_torch.cli import train as tcli
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=12, train_len=60,
                        n_eval=3, eval_len=40, seed=0)
    tr = tcli.main(["--data_dir", data, "--cfg", _ppo_cli_cfg(tmp_path),
                    "--work_dir", str(tmp_path / "w"), "--device", "cpu"])
    assert tr.train_step_num == 3 and tr.gan.gcfg.ppo
    assert tr.gan.disD_opt_state.count == tr.gan.gen_opt_state.count == 2
    with open(os.path.join(tr.work_dir, "train_rank0.log")) as f:
        lines = [l for l in f.read().splitlines() if "Train Step" in l]
    assert all("gen_loss=0.0000" not in l for l in lines[1:])
    payload = tckpt.load_gan_payload(tr.work_dir, "checkpoint_last")
    live = tr.gan.disD_params()
    assert payload["disD_opt_state"].count == 2
    assert all(torch.equal(payload["disD_params"][k], live[k]) for k in live)
    again = tcli.main(["--data_dir", data, "--cfg", _ppo_cli_cfg(
        tmp_path, max_step=4), "--work_dir", tr.work_dir, "--restart",
        "--device", "cpu"])
    assert again.train_step_num == 4
    assert again.gan.disD_opt_state.count == 3
    assert again.gan.gen_opt_state.count == 3 and again.gan.P0_initialized


@pytest.mark.parametrize("init", ["uniform", "normal", "truncated_normal"])
def test_vanilla_cnn_classifier_matches_jax(init):
    """The vanilla CNN classifier (kept for the inventory; nothing routes
    through it): parameters bit for bit, the padding row zero, features
    and logits with and without dropout (the JAX draws)."""
    kw = dict(embed_dim=8, vocab_size=V, init=init, num_filters=(6, 5, 4, 3))
    jcfg, tcfg = jdisc.CnnConfig(**kw), tdisc.CnnConfig(**kw)
    jp = jdisc.init_cnn_params(jcfg, seed=4)
    tp = tdisc.init_cnn_params(tcfg, seed=4)
    ref = flat_tree(jp)
    assert set(tp) == set(ref) and not tp["embeddings"][1].any()
    for k, v in ref.items():
        np.testing.assert_array_equal(tp[k].numpy(), v, err_msg=k)
    ids = np.random.RandomState(0).randint(0, V, (5, 12))
    key = jax.random.PRNGKey(9)
    u = jax.random.uniform(key, (5, jcfg.feature_dim), jnp.float32)
    _close(tdisc.cnn_features(tp, tcfg, torch.from_numpy(ids)),
           jdisc.cnn_features(jp, jcfg, jnp.asarray(ids)), rtol=1e-5,
           atol=1e-6)
    for train in (False, True):
        _close(tdisc.cnn_logits(tp, tcfg, torch.from_numpy(ids), train=train,
                                dropout_u=torch.from_numpy(np.array(u))),
               jdisc.cnn_logits(jp, jcfg, jnp.asarray(ids), train=train,
                                rng=key), rtol=1e-5, atol=1e-6)


def test_gan_reference_kink_rule():
    """The card check's kink rule: ``kernel_check.kink_stats`` reports the
    FF units whose sign differs within the band (relative to the row's
    largest |pre-activation|) and counts the differences outside it, and a
    run replaying another's record (``_FFPre(replay=...)``) takes that
    run's ReLU decisions only within the band: its own record gives the
    same gradients bit for bit, one flip near zero moves its ff_b1 entry's
    gradient, one flip far from zero moves nothing. The record does not
    change the pass; the planted fault does."""
    band = 2.0 ** -10
    own = [torch.full((2, 3, 4, 6), 0.5) for _ in range(2)]
    for o in own:
        o[..., 0] = 1.0                                  # each row's scale
    card = [x.clone() for x in own]
    own[1][1, 2, 0, 5], card[1][1, 2, 0, 5] = 1e-4, -1e-4    # near: replay
    own[0][0, 0, 3, 2], card[0][0, 0, 3, 2] = -3e-4, 2e-4    # near: replay
    own[0][1, 1, 1, 4], card[0][1, 1, 1, 4] = 0.25, -0.25    # far: a fault
    st = kc.kink_stats(card, own, band)
    assert st["kink_units"] == [(0, 2), (1, 5)]
    assert st["kink_max_rel"] == pytest.approx(3e-4)
    assert st["kink_outside"] == 1
    assert st["ff_pre_spread"] == pytest.approx(0.5)
    assert kc.kink_stats(own, own, band)["kink_units"] == []
    with pytest.raises(ValueError):
        kc.kink_stats(card, own[:1], band)

    cfg = txl.XLConfig(n_layer=2, n_head=2, d_model=8, d_inner=6, n_token=20)
    params = txl.init_xl_params(cfg, seed=3, base_init=("normal", 0.5))
    rng = np.random.RandomState(0)
    inp = torch.nn.functional.one_hot(torch.from_numpy(
        rng.randint(0, 20, (3, 2))), 20).float()
    mem = [torch.from_numpy(rng.randn(2, 2, 4, 4).astype(np.float32))
           for _ in range(2)]

    def grads(replay=None, plant=False, band=band):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        with kc._FFPre(replay=replay, band=band, plant=plant) as ff:
            logits = txl.decode_recompute_window(
                leaves, cfg, inp, torch.stack(mem), torch.stack(mem), 2)[0]
        logits.sum().backward()
        return ff.pre, {k: v.grad for k, v in leaves.items()}

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    txl.decode_recompute_window(leaves, cfg, inp, torch.stack(mem),
                                torch.stack(mem), 2)[0].sum().backward()
    plain = {k: v.grad for k, v in leaves.items()}
    pre, g = grads()
    assert len(pre) == 1 and pre[0].shape == (2, 3, 2, 6)
    assert all(torch.equal(plain[k], g[k]) for k in g)   # recording is inert
    same_pre, same = grads(pre)
    assert torch.equal(same_pre[0], pre[0])
    assert all(torch.equal(same[k], g[k]) for k in g)
    t, lane, j = (pre[0][1] > 0).nonzero()[0].tolist()   # passes in layer 1
    assert float(kc._row_rel(pre[0])[1, t, lane, j]) > band
    flipped = pre[0].clone()
    flipped[1, t, lane, j] = -1e-6
    b1 = "layers.1.ff_b1"
    rec, kept = grads([flipped])                          # far from zero
    assert all(torch.equal(kept[k], g[k]) for k in g)
    rec, moved = grads([flipped], band=1.0)               # all in the band
    assert not torch.equal(moved[b1][j], g[b1][j])
    # the record is the run's own pre-activations, not the decisions taken
    assert torch.equal(rec[0], pre[0])
    planted, _ = grads(plant=True)
    assert not torch.equal(planted[0], pre[0])
