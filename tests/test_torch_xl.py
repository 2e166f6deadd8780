"""Port Transformer-XL (transformer_gan_torch.models.xl) against the JAX
package, fp32 on the CPU: the batch forward that primes memory (logits and
memories through growing count) and the chunked decode step (through a
chunk boundary and a merge). Tolerance: atol 1e-4 (fp32, sums in another
order, compounded over layers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch import convert
from transformer_gan_torch.models import xl as txl
from transformer_gan_tpu.models import xl as jxl

torch.set_num_threads(1)

ATOL = 1e-4


def _models(pre_lnorm=False, tie=True, clamp_len=-1):
    base = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=310,
                dropout=0.0, dropatt=0.0, pre_lnorm=pre_lnorm,
                tie_embedding=tie, clamp_len=clamp_len)
    jcfg = jxl.XLConfig(cache_kv=True, use_pallas=False, **base)
    tcfg = txl.XLConfig(cache_kv=True, **base)
    jp = jxl.init_xl_params(jcfg, seed=0, base_init=("normal", 0.1))
    return jcfg, tcfg, jp, convert.params_from_jax(jp)


def test_positional_embedding_matches_jax():
    _, tcfg, _, _ = _models(clamp_len=7)
    jcfg = jxl.XLConfig(d_model=16, clamp_len=7)
    np.testing.assert_allclose(
        txl.positional_embedding(tcfg, 20).numpy(),
        np.asarray(jxl.positional_embedding(jcfg, 20)), atol=1e-6)


@pytest.mark.parametrize("pre_lnorm,tie,same_length", [
    (False, True, True),
    (True, False, True),
    (False, True, False),
])
def test_forward_generate_through_growing_count(pre_lnorm, tie, same_length):
    """Windows of 9, 9, 9 and 1 tokens into a 16-slot ring: count goes
    0 -> 9 -> 16 (full) and the ring wraps."""
    jcfg, tcfg, jp, tp = _models(pre_lnorm, tie)
    rng = np.random.RandomState(1)
    bsz, M = 2, 16
    jm = jxl.init_mems(jcfg, M, bsz)
    tm = txl.init_mems(tcfg, M, bsz)
    for qlen in (9, 9, 9, 1):
        data = rng.randint(0, 310, (qlen, bsz)).astype(np.int32)
        jl, jm = jxl.forward_generate(jp, jcfg, jnp.asarray(data), jm,
                                      same_length=same_length)
        tl, tm = txl.forward_generate(tp, tcfg, torch.from_numpy(data).long(),
                                      tm, same_length=same_length)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_allclose(tm.hids.numpy(), np.asarray(jm.hids),
                                   atol=ATOL)
        assert tm.count == int(jm.count)


def test_decode_state_layout_round_trip():
    _, tcfg, _, tp = _models()
    mems = txl.XLMems(hids=torch.randn(2, 2, 2, 3, 10, 8), count=7)
    state = txl.decode_state_from_mems(tp, tcfg, mems)
    assert state.kv[0][0].shape == (3, 10, 16)
    assert state.r_heads.shape == (2, 11, 2, 8)
    back = txl.mems_from_decode_state(tcfg, state)
    assert torch.equal(back.hids, mems.hids) and back.count == 7


@pytest.mark.parametrize("same_length", [True, False])
def test_decode_chunk_step_over_chunk_boundary_and_merge(same_length):
    """Primed memory (count 7 of 12), two chunks of 5 decode steps with a
    merge between them: per-step logits, staged K/V and the merged state
    against JAX decode_chunk_step / merge_decode_state (per-head layout)."""
    jcfg, tcfg, jp, tp = _models(pre_lnorm=True)
    rng = np.random.RandomState(2)
    bsz, M, C = 3, 12, 5
    prime = rng.randint(0, 310, (7, bsz)).astype(np.int32)
    _, jm = jxl.forward_generate(jp, jcfg, jnp.asarray(prime),
                                 jxl.init_mems(jcfg, M, bsz), same_length=True)
    _, tm = txl.forward_generate(tp, tcfg, torch.from_numpy(prime).long(),
                                 txl.init_mems(tcfg, M, bsz), same_length=True)
    js = jxl.decode_state_from_mems(jp, jcfg, jm, fused_rows=False)
    ts = txl.decode_state_from_mems(tp, tcfg, tm)
    for chunk in range(2):
        jst = jxl.init_decode_stage(jcfg, C, bsz)
        tst = txl.init_decode_stage(tcfg, C, bsz)
        for t in range(C):
            tok = rng.randint(0, 310, (bsz,)).astype(np.int32)
            jl, jst = jxl.decode_chunk_step(jp, jcfg, jnp.asarray(tok), js,
                                            jst, jnp.int32(t),
                                            same_length=same_length)
            tl, tst = txl.decode_chunk_step(tp, tcfg,
                                            torch.from_numpy(tok).long(), ts,
                                            tst, t, same_length=same_length)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        for (jk, jv), (tk, tv) in zip(jst, tst):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
        js = jxl.merge_decode_state(jcfg, js, jst, C)
        ts = txl.merge_decode_state(tcfg, ts, tst, C)
        assert ts.count == int(js.count)
    for (jk, jv), (tk, tv) in zip(js.kv, ts.kv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_merge_refuses_chunk_longer_than_ring():
    _, tcfg, _, tp = _models()
    state = txl.decode_state_from_mems(tp, tcfg, txl.init_mems(tcfg, 4, 1))
    stage = txl.init_decode_stage(tcfg, 6, 1)
    with pytest.raises(ValueError):
        txl.merge_decode_state(tcfg, state, stage, 6)


def test_raw_hidden_memory_not_ported():
    """The raw-hidden memory runs (its JAX parity is in
    tests/test_torch_raw_memory.py): [n_layer + 1, M, b, d] hiddens, a
    forward that fills them, and no fused route or chunked decode on it."""
    cfg = txl.XLConfig(cache_kv=False, n_layer=1, n_head=2, d_model=8,
                       d_inner=16)
    params = txl.init_xl_params(cfg, seed=0)
    mems = txl.init_mems(cfg, 4, 1)
    assert mems.hids.shape == (2, 4, 1, 8)
    data = torch.tensor([[5], [6], [7]])
    _, new = txl.xl_forward(params, cfg, data, mems)
    assert new.count == 3 and float(new.hids[:, -3:].abs().min()) > 0
    with pytest.raises(ValueError):
        txl.xl_forward(params, cfg, data, mems, route="v2")
    with pytest.raises(ValueError):
        txl.decode_state_from_mems(params, cfg, mems)
