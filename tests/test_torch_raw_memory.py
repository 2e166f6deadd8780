"""The raw-hidden memory (``cache_kv`` off: every layer's input hiddens in
the ring, QKV re-projected over [memory; segment]) and the rolling samplers
of the port against the JAX package's raw path, fp32 on the CPU at a tiny
width (2 layers, 2 heads, d_model 16, V 310).

* ``rel_attention``; ``forward_nll``'s loss, every parameter gradient
  (``qkv_w`` included) and the new memories over four segments with a
  mid-stream reset, post- and pre-norm; ``forward_generate``;
* the rolling ``sample_scan`` and ``generate_tokens_gumbel`` id for id on
  the JAX sampler's noise, and raw against the port's chunked decode;
* ``gen_scan`` (the rolling GAN sampler) on the uniforms of JAX's
  ``gen_scan(noise=)``: samples, a loss and every gradient; the GAN's dis
  and gen losses and gradients under ``cache_kv: false`` and under
  ``gan_decode_cache: rolling`` with the JAX draws.

Tolerances are those of tests/test_torch_train.py and tests/test_torch_gan.py:
loss rtol 1e-5 (GAN losses rtol 1e-6), gradients rtol 5e-4 / atol 1e-6
(GAN gradients rtol 2e-4 / atol 1e-7), memories and logits rtol 1e-5 /
atol 1e-6; sampled ids exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch import convert
from transformer_gan_torch.infer import sample as tsample
from transformer_gan_torch.models import attention as tattn
from transformer_gan_torch.models import discriminator as tdisc
from transformer_gan_torch.models import gan as tgan
from transformer_gan_torch.models import xl as txl
from transformer_gan_tpu.infer import sample as jsample
from transformer_gan_tpu.models import attention as jattn
from transformer_gan_tpu.models import discriminator as jdisc
from transformer_gan_tpu.models import gan as jgan
from transformer_gan_tpu.models import xl as jxl

from test_torch_gan import JaxDraws, _t, flat_tree
from test_torch_generate import _g_all
from test_torch_metrics import _jax_gumbel

torch.set_num_threads(1)

V = 310
BASE = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=V,
            dropout=0.0, dropatt=0.0)


def _models(cache_kv=False, **over):
    kw = {**BASE, **over}
    jcfg = jxl.XLConfig(cache_kv=cache_kv, use_pallas=False, **kw)
    tcfg = txl.XLConfig(cache_kv=cache_kv, **kw)
    jp = jxl.init_xl_params(jcfg, seed=0, base_init=("normal", 0.1))
    return jcfg, tcfg, jp, convert.params_from_jax(jp)


def _grads(jg):
    return {k: v.numpy() for k, v in convert.params_from_jax(jg).items()}


def test_init_mems_layouts():
    _, tcfg, _, _ = _models()
    m = txl.init_mems(tcfg, 12, 3)
    assert m.hids.shape == (3, 12, 3, 16) and m.count == 0
    assert (m.mem_len, m.batch_axis) == (12, 2)
    assert m.rows(1, 3).hids.shape == (3, 12, 2, 16)
    _, kcfg, _, _ = _models(cache_kv=True)
    k = txl.init_mems(kcfg, 12, 3)
    assert k.hids.shape == (2, 2, 2, 3, 12, 8)
    assert (k.mem_len, k.batch_axis) == (12, 3)


def test_rel_attention_matches_jax():
    """The raw attention over [memory; segment] with a reset row and a
    partly filled ring."""
    rng = np.random.RandomState(1)
    q, M, b, h, dh = 5, 7, 2, 2, 8
    d = h * dh
    w = rng.randn(q, b, d).astype(np.float32)
    cat = np.concatenate([rng.randn(M, b, d).astype(np.float32), w])
    r = rng.randn(M + q, d).astype(np.float32)
    qkv_w, r_w = (rng.randn(d, k * d).astype(np.float32) * 0.3 for k in (3, 1))
    r_w_bias, r_r_bias = (rng.randn(h, dh).astype(np.float32) for _ in "ab")
    reset = np.array([False, True])
    jmask = jxl.build_attn_mask(q, M, 4, jnp.asarray(reset), True, b)
    ref = jattn.rel_attention(jnp.asarray(w), jnp.asarray(cat), jnp.asarray(r),
                              jnp.asarray(qkv_w), jnp.asarray(r_w), None,
                              jnp.asarray(r_w_bias), jnp.asarray(r_r_bias),
                              jmask, h, dh)
    tmask = tattn.build_attn_mask(q, M, 4, True, torch.from_numpy(reset))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    got = tattn.rel_attention(*(torch.from_numpy(x) for x in (
        w, cat, r, qkv_w, r_w, r_w_bias, r_r_bias)), tmask, h, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("pre_lnorm", [False, True])
def test_forward_nll_raw_matches_jax(pre_lnorm):
    """Four 6-token segments into a 10-slot ring (count 0 -> 6 -> 10 full,
    then full again) with a reset row in segment 2: per segment the NLL,
    every parameter gradient and the new memory against JAX's raw path."""
    jcfg, tcfg, jp, _ = _models(pre_lnorm=pre_lnorm)
    bsz, qlen, M = 2, 6, 10
    rng = np.random.RandomState(3)
    jm, tm = jxl.init_mems(jcfg, M, bsz), txl.init_mems(tcfg, M, bsz)
    for seg in range(4):
        data, target = (rng.randint(0, V, (qlen, bsz)) for _ in "dt")
        reset = np.array([False, seg == 2])

        def loss_j(p):
            nll, new = jxl.forward_nll(p, jcfg, jnp.asarray(data),
                                       jnp.asarray(target),
                                       jnp.asarray(reset), jm)
            return nll.mean(), (nll, new)

        (_, (jnll, jnew)), jg = jax.value_and_grad(loss_j, has_aux=True)(jp)
        tp = {k: v.requires_grad_() for k, v in
              convert.params_from_jax(jp).items()}
        tnll, tnew = txl.forward_nll(tp, tcfg, torch.from_numpy(data),
                                     torch.from_numpy(target),
                                     torch.from_numpy(reset), tm)
        tnll.mean().backward()
        np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll),
                                   rtol=1e-5, atol=1e-6)
        ref = _grads(jg)
        assert set(ref) == set(tp)
        for k, v in tp.items():
            np.testing.assert_allclose(v.grad.numpy(), ref[k], rtol=5e-4,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tnew.hids.numpy(), np.asarray(jnew.hids),
                                   rtol=1e-5, atol=1e-6)
        assert tnew.count == int(jnew.count) and not tnew.hids.requires_grad
        jm, tm = jnew, tnew


def test_raw_and_cached_memory_differ_in_the_qkv_gradient_only():
    """The same weights and segments on both layouts: equal losses, and a
    ``qkv_w`` gradient that differs once the memory holds tokens (the raw
    path re-projects the detached memory hiddens through qkv_w)."""
    _, rcfg, _, tp = _models()
    _, kcfg, _, _ = _models(cache_kv=True)
    rng = np.random.RandomState(5)
    mems = {c: txl.init_mems(c, 8, 2) for c in (rcfg, kcfg)}
    for seg in range(2):
        data, target = (torch.from_numpy(rng.randint(0, V, (6, 2)))
                        for _ in "dt")
        out = {}
        for c in (rcfg, kcfg):
            p = {k: v.clone().requires_grad_() for k, v in tp.items()}
            nll, mems[c] = txl.forward_nll(p, c, data, target, None, mems[c])
            nll.mean().backward()
            out[c] = (float(nll.detach().mean()), {k: v.grad for k, v in p.items()})
        assert out[rcfg][0] == pytest.approx(out[kcfg][0], rel=1e-5)
        diff = (out[rcfg][1]["layers.1.qkv_w"]
                - out[kcfg][1]["layers.1.qkv_w"]).abs().max()
        if seg == 0:
            assert float(diff) < 1e-6
        else:
            assert float(diff) > 1e-3 * float(
                out[kcfg][1]["layers.1.qkv_w"].abs().max())
        torch.testing.assert_close(out[rcfg][1]["layers.1.o_w"],
                                   out[kcfg][1]["layers.1.o_w"], rtol=5e-4,
                                   atol=1e-6)


def test_forward_generate_raw_matches_jax():
    jcfg, tcfg, jp, tp = _models()
    rng = np.random.RandomState(2)
    jm, tm = jxl.init_mems(jcfg, 9, 3), txl.init_mems(tcfg, 9, 3)
    for q in (5, 1, 7):
        data = rng.randint(0, V, (q, 3))
        jl, jm = jxl.forward_generate(jp, jcfg, jnp.asarray(data), jm,
                                      same_length=True)
        tl, tm = txl.forward_generate(tp, tcfg, torch.from_numpy(data), tm,
                                      same_length=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tm.hids.numpy(), np.asarray(jm.hids),
                                   rtol=1e-5, atol=1e-6)
        assert tm.count == int(jm.count)


@pytest.mark.parametrize("technique", ["topk", "nucleus"])
def test_rolling_sample_scan_matches_jax(technique):
    """Prime 12 tokens into a 16-slot ring, then sample 20 past its end
    (the same_length window drops the oldest slots): ids, final memory."""
    jcfg, tcfg, jp, tp = _models()
    js = jsample.SamplingConfig(technique=technique, topk=5, nucleus_p=0.8,
                                temperature=0.9, num_empty_to_ignore=1)
    ts = tsample.SamplingConfig(technique=technique, topk=5, nucleus_p=0.8,
                                temperature=0.9, num_empty_to_ignore=1)
    bsz, M, length = 2, 16, 20
    prime = np.random.RandomState(4).randint(2, V, (12, bsz))
    _, jm = jsample.make_prime_step(jcfg)(jp, jnp.asarray(prime),
                                          jxl.init_mems(jcfg, M, bsz))
    _, tm = tsample.make_prime_step(tcfg)(tp, torch.from_numpy(prime),
                                          txl.init_mems(tcfg, M, bsz))
    first = prime[-1].astype(np.int32)
    key = jax.random.PRNGKey(7)
    jt, jm2 = jsample.sample_scan(jp, jcfg, js, jnp.asarray(first), jm,
                                  length, key)
    tt, tm2 = tsample.sample_scan(tp, tcfg, ts, torch.from_numpy(first).long(),
                                  tm, length,
                                  torch.from_numpy(_g_all(key, length, bsz)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tm2.hids.numpy(), np.asarray(jm2.hids),
                               rtol=1e-5, atol=1e-5)
    assert tm2.count == int(jm2.count)


@pytest.mark.parametrize("M,seq_len,bsz", [(16, 33, 2), (8, 21, 33)])
def test_generate_tokens_gumbel_raw_matches_jax_and_chunked(M, seq_len, bsz):
    """The metrics' gumbel-argmax sampler on raw memory against JAX's raw
    path (its forward_generate_gumbel loop) and against the port's chunked
    decode on the cached layout, same noise; 33 lanes run as sub-waves of
    32 and 1."""
    jcfg, tcfg, jp, tp = _models()
    _, kcfg, _, _ = _models(cache_kv=True)
    key = jax.random.PRNGKey(seq_len)
    first = np.zeros((bsz,), np.int32)
    ref = jsample.generate_tokens_gumbel(jp, jcfg, 1.0, seq_len,
                                         jnp.asarray(first),
                                         jxl.init_mems(jcfg, M, bsz), key)
    g = torch.from_numpy(_jax_gumbel(key, seq_len - 1, bsz))
    first_t = torch.from_numpy(first).long()
    raw = tsample.generate_tokens_gumbel(tp, tcfg, seq_len, first_t,
                                         txl.init_mems(tcfg, M, bsz), g)
    chunked = tsample.generate_tokens_gumbel(tp, kcfg, seq_len, first_t,
                                             txl.init_mems(kcfg, M, bsz), g)
    assert raw.shape == (seq_len, bsz)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(raw.numpy(), chunked.numpy())
    assert len(np.unique(raw.numpy())) > 20


# ---------------------------------------------------------------------------
# The rolling GAN sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_kv", [False, True])
def test_gen_scan_noise_matches_jax(cache_kv):
    """gen_scan over 9 steps from a primed 8-slot ring (it wraps), a
    truncated step in the middle, on JAX's injected uniforms: the samples,
    the memory and the gradient of a fixed projection of the samples in
    every generator weight, on raw memory and on the K/V cache."""
    jcfg, tcfg, jp, _ = _models(cache_kv=cache_kv)
    gk = dict(dis_type="cnn", tgt_len=16, mem_len=8, context_len=3,
              n_token=V)
    jg = jgan.GanConfig(decode_cache="rolling", **gk)
    tg = tgan.GanConfig(decode_cache="rolling", **gk)
    rng = np.random.RandomState(6)
    bsz, n = 3, 9
    data = rng.randint(2, V, (16, bsz))
    u = rng.uniform(size=(n, bsz, V)).astype(np.float32)
    proj = rng.randn(n, bsz, V).astype(np.float32)
    flags = np.zeros(n, bool)
    flags[4] = True
    prev = np.eye(V, dtype=np.float32)[data[2]]
    T = 0.8

    def jloss(p):
        mems = jgan.prime_context(p, jcfg, jg, jnp.asarray(data))
        s, m, _ = jgan.gen_scan(p, jcfg, jg, T, mems, jnp.asarray(prev),
                                jnp.asarray(flags), jax.random.PRNGKey(0),
                                noise=jnp.asarray(u))
        return (s * proj).sum(), (s, m)

    (jval, (js, jm)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: v.requires_grad_() for k, v in
          convert.params_from_jax(jp).items()}
    mems = tgan.prime_context(tp, tcfg, tg, torch.from_numpy(data))
    ts, tm, _ = tgan.gen_scan(tp, tcfg, T, mems, torch.from_numpy(prev),
                              flags.tolist(), tgan.gumbel(torch.from_numpy(u)))
    tval = (ts * torch.from_numpy(proj)).sum()
    tval.backward()
    np.testing.assert_array_equal(ts.detach().numpy(), np.asarray(js))
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)
    np.testing.assert_allclose(tm.hids.numpy(), np.asarray(jm.hids),
                               rtol=1e-5, atol=1e-6)
    ref = _grads(jgrad)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), ref[k], rtol=5e-4,
                                   atol=1e-6, err_msg=k)


def _gan_setup(cache_kv: bool, decode_cache: str, loss_type: str):
    jxcfg, txcfg, jgp, _ = _models(cache_kv=cache_kv)
    common = dict(dis_type="cnn", loss_type=loss_type, tgt_len=16,
                  mem_len=16, context_len=3, sample_chunks_mem=2, n_token=V,
                  decode_cache=decode_cache)
    jg, tg = jgan.GanConfig(**common), tgan.GanConfig(**common)
    rj = jdisc.RelganConfig(embed_dim=16, num_rep=4, vocab_size=V)
    rt = tdisc.RelganConfig(embed_dim=16, num_rep=4, vocab_size=V)
    jdp = jdisc.init_relgan_params(rj, seed=1)
    data = np.random.RandomState(3).randint(2, V, (16, 4))
    return jxcfg, txcfg, jgp, jg, tg, rj, rt, jdp, data


@pytest.mark.parametrize("cache_kv,decode_cache", [(False, "auto"),
                                                   (True, "rolling")])
def test_gan_gen_losses_and_grads_match_jax(cache_kv, decode_cache):
    """The gen phase on the rolling sampler (two chunks): the loss and every
    generator gradient, with the JAX draws."""
    (jxcfg, txcfg, jgp, jg, tg, rj, rt, jdp, data) = _gan_setup(
        cache_kv, decode_cache, "rsgan")
    key, T = jax.random.PRNGKey(11), 0.9

    def jloss(gp):
        losses, _ = jgan.gan_losses_for_batch(gp, jdp, rj, jxcfg, jg,
                                              jnp.asarray(data), T, key,
                                              train_dis=False)
        return losses["gen_loss"]

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(jgp)
    tp = {k: v.requires_grad_(True) for k, v in _t(jgp).items()}
    losses = tgan.gan_losses_for_batch(
        tp, _t(jdp), rt, txcfg, tg, torch.from_numpy(data), T,
        JaxDraws(key, tg.sample_chunks_mem), train_dis=False)
    losses["gen_loss"].backward()
    np.testing.assert_allclose(float(losses["gen_loss"].detach()),
                               float(jval), rtol=1e-6)
    for k, g in flat_tree(jgrad).items():
        np.testing.assert_allclose(tp[k].grad.numpy(), g, rtol=2e-4,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("cache_kv,decode_cache", [(False, "auto"),
                                                   (True, "rolling")])
def test_gan_dis_losses_and_grads_match_jax(cache_kv, decode_cache):
    """The dis phase (wgan-gp, dropout on) on the rolling sampler: losses
    and every discriminator gradient, with the JAX draws; the sampler
    records no graph."""
    (jxcfg, txcfg, jgp, jg, tg, rj, rt, jdp, data) = _gan_setup(
        cache_kv, decode_cache, "wgan-gp")
    key, T = jax.random.PRNGKey(5), 1.0

    def jloss(dp):
        losses, _ = jgan.gan_losses_for_batch(jgp, dp, rj, jxcfg, jg,
                                              jnp.asarray(data), T, key,
                                              train_dis=True)
        return losses["dis_loss"] + losses["gp_loss"], losses

    (_, jl), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jdp)
    tgp = {k: v.requires_grad_(True) for k, v in _t(jgp).items()}
    tdp = {k: v.requires_grad_(True) for k, v in _t(jdp).items()}
    losses = tgan.gan_losses_for_batch(
        tgp, tdp, rt, txcfg, tg, torch.from_numpy(data), T,
        JaxDraws(key, tg.sample_chunks_mem), train_dis=True)
    (losses["dis_loss"] + losses["gp_loss"]).backward()
    assert all(v.grad is None for v in tgp.values())
    for k in ("dis_loss", "gp_loss"):
        np.testing.assert_allclose(float(losses[k].detach()), float(jl[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for k, g in flat_tree(jgrad).items():
        np.testing.assert_allclose(tdp[k].grad.numpy(), g, rtol=2e-4,
                                   atol=1e-7, err_msg=k)


def test_gan_config_decode_cache():
    from transformer_gan_torch.config import training_config
    cfg = training_config()
    cfg.DISCRIMINATOR.type = "cnn"
    cfg.TPU.gan_decode_cache = "rolling"
    assert tgan.GanConfig.from_cfg(cfg, V).decode_cache == "rolling"
    with pytest.raises(ValueError):
        tgan.GanConfig(decode_cache="ring")


def test_mems_rows_of_raw_memory(monkeypatch):
    """A rank's rows of the raw memory [L + 1, M, B, d] lie on axis 2."""
    from transformer_gan_torch.parallel import mesh as pmesh
    from transformer_gan_torch.parallel import sharding as psh
    mems = txl.XLMems(hids=torch.arange(3 * 4 * 8 * 5.0).reshape(3, 4, 8, 5),
                      count=3)
    monkeypatch.setattr(pmesh, "_MESH", pmesh.Mesh(rank=1, world=2))
    part = psh.mems_rows(mems)
    assert torch.equal(part.hids, mems.hids[:, :, 4:]) and part.count == 3
