"""The GAN path's kernels' plain versions in the port against the JAX
package's Pallas kernels in interpret mode, on the CPU in fp32 at a tiny
width (2 layers, 2 heads, d_model 16, B 8, V 310): the gumbel sampler
(K4 ``fused_decode_chunk``, K5 ``fused_decode_step``) and the reverse
straight-through chain (K6 ``chain_bwd_q_res``, K7 ``chain_bwd_q``), plus
the window recompute (``decode_recompute_window``) that feeds K6.

Sampled ids and one-hots must be identical and staged K/V within 1e-5; the
chain's Q within rtol 1e-5, atol 1e-6 (fp32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch import convert
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.ops import chain_bwd as tchain
from transformer_gan_torch.ops import decode as tdec
from transformer_gan_torch.ops.decode_params import stack_decode_params
from transformer_gan_tpu.models import xl as jxl
from transformer_gan_tpu.ops import pallas_chain_bwd as pchain
from transformer_gan_tpu.ops import pallas_decode as pdec

torch.set_num_threads(1)

BASE = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=310,
            dropout=0.0, dropatt=0.0)
L, H, DH, V = 2, 2, 8, 310
HD = H * DH


def _models(pre_lnorm=False):
    jcfg = jxl.XLConfig(cache_kv=True, use_pallas=True, pre_lnorm=pre_lnorm,
                        **BASE)
    tcfg = txl.XLConfig(pre_lnorm=pre_lnorm, **BASE)
    # weights of 0.2: logits far enough apart that fp32 sums in another
    # order cannot flip an argmax
    jp = jxl.init_xl_params(jcfg, seed=0, base_init=("normal", 0.2))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _dense(a):
    """[L, H, B, M, dh] h-major -> the JAX kernels' [L, B, M, HD]."""
    Ln, Hn, B, M, dh = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1, 4).reshape(Ln, B, M,
                                                                   Hn * dh))


def _gumbel(rng, shape):
    u = rng.uniform(size=shape).astype(np.float32)
    return -np.log(-np.log(u + 1e-20) + 1e-20)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pdec, "INTERPRET", True)
    monkeypatch.setattr(pchain, "INTERPRET", True)


# ---------------------------------------------------------------------------
# K4 / K5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,M,n,count,pre", [
    (8, 16, 5, 0, False),     # empty ring: only staged lanes
    (8, 16, 7, 9, False),     # partly filled ring
    (16, 16, 16, 16, False),  # full ring, chunk = M (sliding window)
    (8, 16, 6, 11, True),     # pre-LN
])
def test_decode_chunk_plain_matches_jax_kernel(B, M, n, count, pre):
    jcfg, tcfg, jp, tp = _models(pre)
    rng = np.random.RandomState(B + n + count)
    kv = rng.randn(L, 2, H, B, M, DH).astype(np.float32)
    R = np.asarray(jxl.precompute_r_heads(jp, jcfg, M + 1)).reshape(L, M + 1,
                                                                     HD)
    ids = rng.randint(2, V, (B, 1)).astype(np.int32)
    g = _gumbel(rng, (n, B, V))
    ji, joh, jsk, jsv = pdec.fused_decode_chunk(
        pdec.stack_decode_params(jp, jcfg), jcfg, jnp.asarray(_dense(kv[:, 0])),
        jnp.asarray(_dense(kv[:, 1])), jnp.asarray(R), jnp.asarray(ids),
        jnp.asarray(g), count, n)
    ti, toh, staged = tdec.fused_decode_chunk(
        stack_decode_params(tp, tcfg), tcfg, torch.from_numpy(kv),
        torch.from_numpy(R), torch.from_numpy(ids), torch.from_numpy(g),
        count, n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(toh.numpy(), np.asarray(joh))
    np.testing.assert_allclose(_dense(staged[:, 0].numpy()),
                               np.asarray(jsk)[:, :, :n], atol=1e-5)
    np.testing.assert_allclose(_dense(staged[:, 1].numpy()),
                               np.asarray(jsv)[:, :, :n], atol=1e-5)


@pytest.mark.parametrize("t,count", [(0, 0), (3, 5), (7, 16)])
def test_decode_step_plain_matches_jax_kernel(t, count):
    jcfg, tcfg, jp, tp = _models()
    B, M, C = 8, 16, 8
    rng = np.random.RandomState(t + count)
    kv = rng.randn(L, 2, H, B, M, DH).astype(np.float32)
    staged = rng.randn(L, 2, H, B, C, DH).astype(np.float32)
    R = np.asarray(jxl.precompute_r_heads(jp, jcfg, M + 1)).reshape(L, M + 1,
                                                                     HD)
    ids = rng.randint(2, V, (B, 1)).astype(np.int32)
    g = _gumbel(rng, (B, V))
    ji, joh, jsk, jsv = pdec.fused_decode_step(
        pdec.stack_decode_params(jp, jcfg), jcfg, jnp.asarray(_dense(kv[:, 0])),
        jnp.asarray(_dense(kv[:, 1])), jnp.asarray(R),
        jnp.asarray(_dense(staged[:, 0])), jnp.asarray(_dense(staged[:, 1])),
        jnp.asarray(ids), jnp.asarray(g), jnp.asarray([t, count], jnp.int32))
    ti, toh, st = tdec.fused_decode_step(
        stack_decode_params(tp, tcfg), tcfg, torch.from_numpy(kv),
        torch.from_numpy(R), torch.from_numpy(staged.copy()),
        torch.from_numpy(ids), torch.from_numpy(g), t, count)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(toh.numpy(), np.asarray(joh))
    np.testing.assert_allclose(_dense(st[:, 0].numpy()), np.asarray(jsk),
                               atol=1e-5)
    np.testing.assert_allclose(_dense(st[:, 1].numpy()), np.asarray(jsv),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# Window recompute, K6 / K7
# ---------------------------------------------------------------------------

def _window_case(B, M, n, count, pre, seed=0):
    jcfg, tcfg, jp, tp = _models(pre)
    rng = np.random.RandomState(seed + n + count)
    ids = rng.randint(2, V, (n, B))
    inputs = np.eye(V, dtype=np.float32)[ids]
    k_mem = rng.randn(L, H, B, M, DH).astype(np.float32)
    v_mem = rng.randn(L, H, B, M, DH).astype(np.float32)
    return jcfg, tcfg, jp, tp, rng, inputs, k_mem, v_mem


@pytest.mark.parametrize("n,count,pre", [(6, 0, False), (8, 8, False),
                                         (5, 3, True)])
def test_decode_recompute_window_matches_jax(n, count, pre):
    B, M = 8, 8
    jcfg, tcfg, jp, tp, _, inputs, k_mem, v_mem = _window_case(B, M, n, count,
                                                                pre)
    jl, jk, jv, jc, jres = jxl.decode_recompute_window(
        jp, jcfg, jnp.asarray(inputs), [jnp.asarray(a) for a in k_mem],
        [jnp.asarray(a) for a in v_mem], count, collect_residuals=True)
    tl, tk, tv, tc, tres = txl.decode_recompute_window(
        tp, tcfg, torch.from_numpy(inputs), torch.from_numpy(k_mem),
        torch.from_numpy(v_mem), count, collect_residuals=True)
    assert tc == int(jc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(tk + tv, jk + jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for key in ("x", "z1", "z2", "ff_pre", "prob"):
        np.testing.assert_allclose(tres[key].numpy(), np.asarray(jres[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("variant", ["res", "recompute"])
@pytest.mark.parametrize("n,count,T,pre", [
    (6, 0, 1.0, False),    # empty memory
    (8, 8, 0.5, False),    # full memory, sharper softmax
    (5, 3, 1.0, True),     # pre-LN
])
def test_chain_plain_matches_jax_kernel(variant, n, count, T, pre):
    B, M = 8, 8
    jcfg, tcfg, jp, tp, rng, inputs, k_mem, v_mem = _window_case(
        B, M, n, count, pre, seed=1)
    jl, jk, jv, _, jres = jxl.decode_recompute_window(
        jp, jcfg, jnp.asarray(inputs), [jnp.asarray(a) for a in k_mem],
        [jnp.asarray(a) for a in v_mem], count, collect_residuals=True)
    g = _gumbel(rng, (n, B, V))
    Y = np.asarray(jax.nn.softmax((jl + g) / T, axis=-1))
    S = rng.randn(n, B, V).astype(np.float32)
    stacked = pdec.stack_decode_params(jp, jcfg)
    r_heads = jxl.precompute_r_heads(jp, jcfg, M + 1).reshape(L, M + 1, HD)
    kf_d = jnp.stack([jnp.asarray(_dense(np.asarray(a)[None])[0]) for a in jk])
    vf_d = jnp.stack([jnp.asarray(_dense(np.asarray(a)[None])[0]) for a in jv])
    if variant == "res":
        jq = pchain.chain_bwd_q_res(stacked, jcfg, kf_d, vf_d, r_heads,
                                    jnp.asarray(S), jnp.asarray(Y), count, T,
                                    jres)
    else:
        jq = pchain.chain_bwd_q(stacked, jcfg, kf_d, vf_d, r_heads,
                                jnp.asarray(inputs.argmax(-1), jnp.int32),
                                jnp.asarray(S), jnp.asarray(Y), count, T)
    kf = torch.from_numpy(np.stack([np.asarray(a) for a in jk]))
    vf = torch.from_numpy(np.stack([np.asarray(a) for a in jv]))
    args = (tp, tcfg, kf, vf, torch.from_numpy(inputs), torch.from_numpy(S),
            torch.from_numpy(Y), count, T)
    if variant == "res":
        res = {k: torch.from_numpy(np.asarray(v)) for k, v in jres.items()}
        tq = tchain.chain_bwd_q_res(*args, res)
    else:
        tq = tchain.chain_bwd_q(*args)
    # Q[0] is the first token's own logits cotangent; the kernels' chi for
    # the token before the chunk is never used
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-6)
