"""Port attention (transformer_gan_torch) against the JAX package, fp32 on
the CPU: the plain ``rel_attention_kv`` and the two fused-kernel contracts
(whose CPU route is the kernels' plain version) against JAX
``rel_attention_kv``, and against the JAX Pallas kernels in interpret mode.
Tolerance: atol 1e-5 (fp32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_gan_torch.models import attention as tatt
from transformer_gan_torch.ops import attention as tops
from transformer_gan_tpu.models import attention as jatt
from transformer_gan_tpu.models import xl as jxl

torch.set_num_threads(1)

H, DH, D = 2, 8, 16
MEM = 12
ATOL = 1e-5


def _inputs(qlen, bsz, seed=0):
    rng = np.random.RandomState(seed)

    def a(*shape, s=0.3):
        return (rng.randn(*shape) * s).astype(np.float32)

    return dict(w=a(qlen, bsz, D, s=1.0), k_mem=a(H, bsz, MEM, DH),
                v_mem=a(H, bsz, MEM, DH), r=a(MEM + qlen, D, s=1.0),
                qkv_w=a(D, 3 * H * DH), r_w=a(D, H * DH),
                r_w_bias=a(H, DH), r_r_bias=a(H, DH))


def _t(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _j(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _jax_ref(x, qlen, bsz, count, same_length, reset=None):
    mask = jxl.build_attn_mask(qlen, MEM, jnp.int32(count),
                               None if reset is None else jnp.asarray(reset),
                               same_length, bsz)
    j = _j(x)
    return jatt.rel_attention_kv(
        j["w"], j["k_mem"], j["v_mem"], j["r"], j["qkv_w"], j["r_w"],
        j["r_w_bias"], j["r_r_bias"], mask, H, DH)


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0)


def test_layer_norm_matches_jax():
    rng = np.random.RandomState(1)
    x, s, b = (rng.randn(3, 5, 40).astype(np.float32),
               rng.randn(40).astype(np.float32),
               rng.randn(40).astype(np.float32))
    got = tatt.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                          torch.from_numpy(b))
    ref = jatt.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_rel_shift_matches_jax():
    x = np.random.RandomState(2).randn(2, 3, 5, 9).astype(np.float32)
    np.testing.assert_array_equal(
        tatt.rel_shift(torch.from_numpy(x)).numpy(),
        np.asarray(jatt.rel_shift(jnp.asarray(x))))


GRID = [(q, count, sl) for q in (1, 9, 16) for count in (0, 5, MEM)
        for sl in (False, True)]


@pytest.mark.parametrize("qlen,count,same_length", GRID)
def test_attention_paths_match_jax(qlen, count, same_length):
    """Plain attention and both fused contracts against JAX
    rel_attention_kv over count in {0, partial, full}, same_length on/off
    and q in {1, 9, 16}."""
    bsz = 2
    x = _inputs(qlen, bsz, seed=qlen + count)
    ref = _jax_ref(x, qlen, bsz, count, same_length)
    t = _t(x)
    mask = tatt.build_attn_mask(qlen, MEM, count, same_length)
    plain = tatt.rel_attention_kv(
        t["w"], t["k_mem"], t["v_mem"], t["r"], t["qkv_w"], t["r_w"],
        t["r_w_bias"], t["r_r_bias"], mask, H, DH)
    _close(plain, ref)
    for fused in (tops.rel_attention_kv_fused_v2, tops.rel_attention_kv_fused):
        got = fused(t["w"], t["k_mem"], t["v_mem"], t["r"], t["qkv_w"],
                    t["r_w"], t["r_w_bias"], t["r_r_bias"], count, None,
                    H, DH, same_length=same_length)
        _close(got, ref)


def test_fused_contracts_with_reset_rows():
    """Per-row reset masks the whole memory of that row (K2f's reset
    operand; the v2 contract takes it per batch row)."""
    qlen, bsz, count = 9, 3, 7
    x = _inputs(qlen, bsz, seed=4)
    reset = np.array([False, True, False])
    ref = _jax_ref(x, qlen, bsz, count, True, reset=reset)
    t = _t(x)
    for fused in (tops.rel_attention_kv_fused_v2, tops.rel_attention_kv_fused):
        got = fused(t["w"], t["k_mem"], t["v_mem"], t["r"], t["qkv_w"],
                    t["r_w"], t["r_w_bias"], t["r_r_bias"], count,
                    torch.from_numpy(reset), H, DH, same_length=True)
        _close(got, ref)


def test_fused_contracts_match_pallas_interpret(monkeypatch):
    """The port's fused contracts against the JAX Pallas kernels (v2 and
    v1) run in interpret mode, including the saved row max and sum."""
    from transformer_gan_tpu.ops import pallas_attention as pa
    from transformer_gan_tpu.ops import pallas_attention_v2 as pa2
    monkeypatch.setattr(pa, "INTERPRET", True)
    monkeypatch.setattr(pa2, "INTERPRET", True)
    # keep the TPU kernel's position-term shifts at fp32 width on the CPU
    monkeypatch.setattr(pa2, "_FAST_BF16_SHIFT", [False])
    qlen, bsz, count = 16, 2, 5
    x = _inputs(qlen, bsz, seed=9)
    j, t = _j(x), _t(x)
    args_j = (j["w"], j["k_mem"], j["v_mem"], j["r"], j["qkv_w"], j["r_w"],
              j["r_w_bias"], j["r_r_bias"], jnp.int32(count), None, H, DH)
    args_t = (t["w"], t["k_mem"], t["v_mem"], t["r"], t["qkv_w"], t["r_w"],
              t["r_w_bias"], t["r_r_bias"], count, None, H, DH)
    _close(tops.rel_attention_kv_fused_v2(*args_t, same_length=True),
           pa2.rel_attention_kv_fused_v2(*args_j, same_length=True))
    _close(tops.rel_attention_kv_fused(*args_t, same_length=False),
           pa.rel_attention_kv_fused(*args_j, same_length=False))

    # raw kernel outputs (o, m, l) of K1f on identical operands
    rng = np.random.RandomState(3)
    qrw, qrr, kc, vc = (rng.randn(H, bsz, qlen, DH).astype(np.float32) * 0.3
                        for _ in range(4))
    km, vm = (rng.randn(H, bsz, MEM, DH).astype(np.float32) * 0.3
              for _ in range(2))
    rk = rng.randn(H, MEM + 2 * qlen, DH).astype(np.float32) * 0.3
    rk[:, MEM + qlen:] = 0.0
    ops = (qrw, qrr, km, vm, kc, vc, rk)
    ref = pa2._fwd_raw(*map(jnp.asarray, ops), jnp.asarray([count], jnp.int32),
                       jnp.zeros((bsz,), jnp.int32), jnp.zeros((1,), jnp.int32),
                       1.0, True, 0.0)
    got = tops.xl_attn_fwd_v2(*map(torch.from_numpy, ops), count, None, True)
    _close(got, ref)


def test_kernel_wrappers_refuse_training_inputs():
    """The kernels' wrappers no longer refuse training inputs: the calls
    that raised before the backward kernels were ported now return
    gradients (the contract with dropout, the raw forward with inputs that
    require grad, through XLAttnV2)."""
    qlen, bsz = 9, 1
    t = _t(_inputs(qlen, bsz))
    qkv_w = t["qkv_w"].requires_grad_()
    out = tops.rel_attention_kv_fused_v2(
        t["w"], t["k_mem"], t["v_mem"], t["r"], qkv_w, t["r_w"],
        t["r_w_bias"], t["r_r_bias"], 0, None, H, DH, same_length=True,
        dropatt=0.1, seed=5)
    out[0].sum().backward()
    assert qkv_w.grad is not None and qkv_w.grad.abs().sum() > 0
    q = torch.randn(H, bsz, qlen, DH, requires_grad=True)
    z = torch.zeros(H, bsz, MEM, DH)
    o = tops.XLAttnV2.apply(q, q, z, z, q, q,
                            torch.zeros(H, MEM + 2 * qlen, DH), 0, None, 0,
                            0.0, True)
    o.square().sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert q.grad.abs().sum() > 0
