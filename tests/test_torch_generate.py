"""Port sampling and the generation slice (transformer_gan_torch) against
the JAX package, fp32 on the CPU.

The JAX side draws ``jax.random.gumbel`` on its per-lane keys (what
``jax.random.categorical`` adds) and the port takes the same numbers as
its noise input, so sampled ids must match exactly. Memories: atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch import convert
from transformer_gan_torch.infer import sample as tsample
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.ops import generate as tgen
from transformer_gan_tpu.infer import sample as jsample
from transformer_gan_tpu.models import xl as jxl
from transformer_gan_tpu.ops import pallas_generate as pgen

torch.set_num_threads(1)

V = 310


def _models(pre_lnorm=False):
    base = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=V,
                dropout=0.0, dropatt=0.0, pre_lnorm=pre_lnorm)
    jcfg = jxl.XLConfig(cache_kv=True, use_pallas=False, **base)
    tcfg = txl.XLConfig(cache_kv=True, **base)
    jp = jxl.init_xl_params(jcfg, seed=0, base_init=("normal", 0.1))
    return jcfg, tcfg, jp, convert.params_from_jax(jp)


def _g_all(key, length, bsz):
    """The per-step, per-lane gumbel noise of the JAX sampler's key stream."""
    def g_of(step_rng):
        rs = jax.random.split(step_rng, bsz)
        return jax.vmap(lambda r: jax.random.gumbel(r, (V,), jnp.float32))(rs)
    return np.array(jax.vmap(g_of)(jax.random.split(key, length)))


def _scfg(pair, **kw):
    return pair[0](**kw), pair[1](**kw)


SCFG = (jsample.SamplingConfig, tsample.SamplingConfig)


@pytest.mark.parametrize("technique,temperature", [
    ("topk", 0.02), ("topk", 5.0), ("random", 0.02), ("random", 5.0),
    ("nucleus", 0.02), ("nucleus", 5.0), ("topk", 0.0), ("topk", 0.95),
])
def test_filter_and_sample_matches_jax(technique, temperature):
    """Surgery, filtering and the gumbel draw, id for id, over 64 rows of
    peaked and flat logits with a repeated-TIME_SHIFT_100 counter."""
    js, ts = _scfg(SCFG, technique=technique, topk=5, nucleus_p=0.8,
                   temperature=temperature, exclude_bos=True,
                   num_empty_to_ignore=2)
    rng = np.random.RandomState(3)
    rows = 64
    logits = (rng.randn(rows, V) * rng.choice([0.5, 4.0], (rows, 1))
              ).astype(np.float32)
    logits[::7, 101] += 6.0        # make the empty token a frequent winner
    er = rng.randint(0, 4, rows).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), rows)
    g = np.array(jax.vmap(lambda r: jax.random.gumbel(r, (V,)))(keys))
    ref = jax.vmap(lambda lg, e, r: jsample._filter_and_sample(lg, js, e, r))(
        jnp.asarray(logits), jnp.asarray(er), keys)
    got = tsample._filter_and_sample(torch.from_numpy(logits), ts,
                                     torch.from_numpy(er), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gumbel_noise_is_seeded_and_finite():
    a = tsample.gumbel_noise((4, 3, V), torch.Generator().manual_seed(1))
    b = tsample.gumbel_noise((4, 3, V), torch.Generator().manual_seed(1))
    assert a.shape == (4, 3, V) and a.dtype == torch.float32
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert abs(float(a.mean()) - 0.5772) < 0.05   # Euler-Mascheroni mean


def test_supports_fused_generate_gates():
    _, tcfg, _, _ = _models()
    ts = tsample.SamplingConfig
    assert tgen.supports_fused_generate(tcfg, ts(technique="topk"), 32, 32)
    assert tgen.supports_fused_generate(tcfg, ts(technique="random"), 1, 7)
    assert not tgen.supports_fused_generate(tcfg, ts(technique="nucleus"), 1, 32)
    assert not tgen.supports_fused_generate(tcfg, ts(), 33, 32)
    assert not tgen.supports_fused_generate(tcfg, ts(), 8, 33)


def _prime(jcfg, tcfg, jp, tp, prime, M):
    bsz = prime.shape[1]
    _, jm = jsample.make_prime_step(jcfg)(jp, jnp.asarray(prime),
                                          jxl.init_mems(jcfg, M, bsz))
    _, tm = tsample.make_prime_step(tcfg)(tp, torch.from_numpy(prime).long(),
                                          txl.init_mems(tcfg, M, bsz))
    np.testing.assert_allclose(tm.hids.numpy(), np.asarray(jm.hids), atol=1e-4)
    return jm, tm


def test_slice_prime_and_fused_loop_match_pallas_interpret(monkeypatch):
    """The slice: prime + the fused sampling loop (chunk of 32, then a
    remainder of 8, into a full ring, where the same_length window drops
    the oldest slots) against JAX make_prime_step + _fused_sample_loop on
    the Pallas kernel in interpret mode, same noise.

    M is a multiple of 128 on purpose: with a front-padded ring (M % 128
    != 0) the TPU kernel's big-slot mask compares against the unpadded
    t + 1 and keeps the slots the same_length window drops, so it departs
    from its own jnp oracle once count + t + 1 > M. The port follows the
    oracle; test_sample_scan_matches_jax_oracle covers unaligned M."""
    monkeypatch.setattr(pgen, "INTERPRET", True)
    jcfg, tcfg, jp, tp = _models()
    js, ts = _scfg(SCFG, technique="topk", topk=5, temperature=0.9)
    bsz, M, length = 2, 128, 40
    rng = np.random.RandomState(4)
    prime = rng.randint(2, V, (100, bsz)).astype(np.int32)
    jm, tm = _prime(jcfg, tcfg, jp, tp, prime, M)
    g_all = _g_all(jax.random.PRNGKey(7), length, bsz)
    first = np.full((bsz,), 2, np.int32)
    jt, jK, jV, jc = jsample._fused_sample_loop(
        jp, jcfg, js, jnp.asarray(first), jm, length, jnp.asarray(g_all),
        jnp.zeros((bsz,), jnp.int32), same_length=True)
    tt, thids, tc = tsample._fused_sample_loop(
        tp, tcfg, ts, torch.from_numpy(first).long(), tm, length,
        torch.from_numpy(g_all), torch.zeros(bsz, dtype=torch.long),
        same_length=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))

    def heads(x):  # JAX's dense [L, b, M, h*dh] -> the port's [L, h, b, M, dh]
        L = x.shape[0]
        return np.asarray(x).reshape(L, bsz, M, tcfg.n_head,
                                     tcfg.d_head).transpose(0, 3, 1, 2, 4)
    np.testing.assert_allclose(thids[:, 0].numpy(), heads(jK), atol=1e-4)
    np.testing.assert_allclose(thids[:, 1].numpy(), heads(jV), atol=1e-4)
    assert tc == int(jc) == M


@pytest.mark.parametrize("technique,temperature,num_empty,pre_lnorm", [
    ("topk", 0.95, 0, True),      # the fused loop's plain version
    ("topk", 0.0, 2, False),      # argmax + TIME_SHIFT_100 suppression
    ("nucleus", 0.9, 0, False),   # the plain chunked decode
])
def test_sample_scan_matches_jax_oracle(technique, temperature, num_empty,
                                        pre_lnorm):
    """sample_scan against the JAX jnp sample_scan (chunked decode with
    jax.random.categorical on the same key stream): ids identical,
    memories at atol 1e-4."""
    jcfg, tcfg, jp, tp = _models(pre_lnorm)
    js, ts = _scfg(SCFG, technique=technique, topk=5, nucleus_p=0.9,
                   temperature=temperature, num_empty_to_ignore=num_empty)
    bsz, M, length = 2, 24, 28
    rng = np.random.RandomState(8)
    prime = rng.randint(2, V, (5, bsz)).astype(np.int32)
    jm, tm = _prime(jcfg, tcfg, jp, tp, prime, M)
    key = jax.random.PRNGKey(11)
    first = np.full((bsz,), 7, np.int32)
    jt, jm2 = jsample.sample_scan(jp, jcfg, js, jnp.asarray(first), jm,
                                  length, key)
    tt, tm2 = tsample.sample_scan(tp, tcfg, ts, torch.from_numpy(first).long(),
                                  tm, length,
                                  torch.from_numpy(_g_all(key, length, bsz)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tm2.hids.numpy(), np.asarray(jm2.hids),
                               atol=1e-4)
    assert tm2.count == int(jm2.count)


def test_decode_step_matches_jax():
    """The duration-based loop's single step: ids and memories."""
    jcfg, tcfg, jp, tp = _models()
    js, ts = _scfg(SCFG, technique="topk", topk=8)
    bsz, M = 2, 16
    key = jax.random.PRNGKey(2)
    jm, tm = jxl.init_mems(jcfg, M, bsz), txl.init_mems(tcfg, M, bsz)
    jtok = jnp.asarray([3, 4], jnp.int32)
    ttok = torch.tensor([3, 4])
    jer, ter = jnp.zeros((bsz,), jnp.int32), torch.zeros(bsz, dtype=torch.long)
    jstep, tstep = jsample.make_decode_step(jcfg, js), tsample.make_decode_step(
        tcfg, ts)
    for key in jax.random.split(key, 3):
        g = np.array(jax.vmap(lambda r: jax.random.gumbel(r, (V,)))(
            jax.random.split(key, bsz)))
        jtok, jm, jer = jstep(jp, jm, jtok, jer, key)
        ttok, tm, ter = tstep(tp, tm, ttok, ter, torch.from_numpy(g))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tm.hids.numpy(), np.asarray(jm.hids), atol=1e-4)
