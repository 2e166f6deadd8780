"""The port's attention backward (K1b, K2b) and attention dropout against the
JAX package, fp32 on the CPU, where every kernel wrapper runs its plain
version: the plain K1b / K2b against the Pallas ``_bwd_raw`` /
``_fused_bwd_raw`` in interpret mode on identical operands, the contracts'
gradients (through ``XLAttnV2`` / ``XLAttnV1``) against ``jax.vjp`` of the
JAX contracts and of the jnp ``rel_attention_kv``, fp64 gradcheck, and the
dropout mask's rate, determinism and independence of grid order.

Tolerance: atol 2e-5 (fp32 sums in another order; the port takes
D = rowsum(do * o) where the TPU kernel sums dP * P)."""

import jax
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
ATOL = 2e-5


@pytest.fixture
def interpret(monkeypatch):
    from transformer_gan_tpu.ops import pallas_attention as pa
    from transformer_gan_tpu.ops import pallas_attention_v2 as pa2
    monkeypatch.setattr(pa, "INTERPRET", True)
    monkeypatch.setattr(pa2, "INTERPRET", True)
    monkeypatch.setattr(pa2, "_FAST_BF16_SHIFT", [False])
    return pa, pa2


def _close(got, ref, atol=ATOL):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=atol, rtol=0)


def _a(rng, *shape, s=0.5):
    return (rng.randn(*shape) * s).astype(np.float32)


# ---------------------------------------------------------------------------
# K1b / K2b plain versions against the TPU kernels (interpret mode)
# ---------------------------------------------------------------------------

BWD_GRID = [(M, count, sl, reset) for M, count in ((12, 0), (12, 5), (12, 12),
                                                   (24, 24))
            for sl in (False, True) for reset in (False, True)]


@pytest.mark.parametrize("M,count,same_length,reset", BWD_GRID)
def test_k1b_plain_matches_pallas_bwd(interpret, M, count, same_length,
                                      reset):
    """All five outputs of K1b, drk summed over B = 2, with and without a
    reset row, count 0 / partial / full, same_length on and off."""
    _, pa2 = interpret
    q, B = 16, 2
    rng = np.random.RandomState(M + count + 2 * same_length + reset)
    ops = [_a(rng, H, B, q, DH), _a(rng, H, B, q, DH), _a(rng, H, B, M, DH),
           _a(rng, H, B, M, DH), _a(rng, H, B, q, DH), _a(rng, H, B, q, DH),
           _a(rng, H, M + 2 * q, DH)]
    ops[6][:, M + q:] = 0.0
    do = _a(rng, H, B, q, DH, s=1.0)
    rs = np.array([0, 1] if reset else [0, 0], np.int32)
    jargs = [jnp.asarray(x) for x in ops]
    jc, jr, js = (jnp.asarray([count], jnp.int32), jnp.asarray(rs),
                  jnp.zeros((1,), jnp.int32))
    _, jm, jl = pa2._fwd_raw(*jargs, jc, jr, js, 1.0, same_length, 0.0)
    ref = pa2._bwd_raw(*jargs, jm, jl, jc, jr, js, jnp.asarray(do), 1.0,
                       same_length, 0.0)
    t = [torch.from_numpy(x) for x in ops]
    treset = torch.from_numpy(rs)
    o, m, l = tops.xl_attn_fwd_v2(*t, count, treset, same_length)
    got = tops.xl_attn_bwd_v2(*t, m, l, o, torch.from_numpy(do), count,
                              treset, same_length)
    _close(got, ref)


@pytest.mark.parametrize("M,count,same_length,reset", BWD_GRID[::2])
def test_k2b_plain_matches_pallas_bwd(interpret, M, count, same_length,
                                      reset):
    """dq, dk, dv over every key and dbd = dS * scale of K2b."""
    pa, _ = interpret
    q, BH = 16, 4
    klen, scale = M + q, 1.0 / DH ** 0.5
    rng = np.random.RandomState(100 + M + count)
    ops = [_a(rng, BH, q, DH), _a(rng, BH, klen, DH), _a(rng, BH, klen, DH),
           _a(rng, BH, q, klen)]
    do = _a(rng, BH, q, DH, s=1.0)
    rs = np.array([0, 1, 0, 0] if reset else [0] * 4, np.int32)
    jargs = [jnp.asarray(x) for x in ops]
    jc, jr, js = (jnp.asarray([count], jnp.int32), jnp.asarray(rs),
                  jnp.zeros((1,), jnp.int32))
    _, jm, jl = pa._fused_fwd_raw(*jargs, jc, jr, js, scale, same_length,
                                  0.0)
    ref = pa._fused_bwd_raw(*jargs, jm, jl, jc, jr, js, jnp.asarray(do),
                            scale, same_length, 0.0)
    t = [torch.from_numpy(x) for x in ops]
    treset = torch.from_numpy(rs)
    o, m, l = tops.xl_attn_fwd_v1(*t, count, treset, scale, same_length)
    got = tops.xl_attn_bwd_v1(*t, m, l, o, torch.from_numpy(do), count,
                              treset, scale, same_length)
    _close(got, ref)


# ---------------------------------------------------------------------------
# Contract gradients against jax.vjp
# ---------------------------------------------------------------------------

def _contract_inputs(qlen, bsz, mem, seed):
    rng = np.random.RandomState(seed)
    return dict(w=_a(rng, qlen, bsz, D, s=1.0), k_mem=_a(rng, H, bsz, mem, DH),
                v_mem=_a(rng, H, bsz, mem, DH), r=_a(rng, mem + qlen, D, s=1.0),
                qkv_w=_a(rng, D, 3 * H * DH, s=0.3), r_w=_a(rng, D, H * DH, s=0.3),
                r_w_bias=_a(rng, H, DH, s=0.3), r_r_bias=_a(rng, H, DH, s=0.3))


GRAD_KEYS = ("w", "k_mem", "v_mem", "qkv_w", "r_w", "r_w_bias", "r_r_bias")


def _torch_grads(fused, x, cot, count, reset, same_length):
    t = {k: torch.from_numpy(v).requires_grad_(k in GRAD_KEYS)
         for k, v in x.items()}
    outs = fused(t["w"], t["k_mem"], t["v_mem"], t["r"], t["qkv_w"], t["r_w"],
                 t["r_w_bias"], t["r_r_bias"], count, reset, H, DH,
                 same_length=same_length)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cot])
    return outs, {k: (t[k].grad if t[k].grad is not None
                      else torch.zeros_like(t[k])) for k in GRAD_KEYS}


@pytest.mark.parametrize("variant", ["v2", "v1"])
@pytest.mark.parametrize("count,same_length,reset", [
    (5, True, None), (12, False, [False, True])])
def test_contract_gradients_match_jax(interpret, variant, count, same_length,
                                      reset):
    """Gradients of the fused contracts (CPU route through XLAttnV2 /
    XLAttnV1) against jax.vjp of the JAX contracts in interpret mode and,
    for the inputs both differentiate, of the jnp rel_attention_kv. The v2
    contract stops the memory's gradient (zero), the v1 one passes it."""
    pa, pa2 = interpret
    qlen, bsz, mem = 16, 2, 12
    x = _contract_inputs(qlen, bsz, mem, seed=count)
    rng = np.random.RandomState(7)
    cot = [_a(rng, qlen, bsz, H * DH, s=1.0), _a(rng, H, bsz, qlen, DH),
           _a(rng, H, bsz, qlen, DH)]
    rs = None if reset is None else np.array(reset)
    fused_t = (tops.rel_attention_kv_fused_v2 if variant == "v2"
               else tops.rel_attention_kv_fused)
    fused_j = (pa2.rel_attention_kv_fused_v2 if variant == "v2"
               else pa.rel_attention_kv_fused)
    outs, grads = _torch_grads(fused_t, x, cot, count,
                               None if rs is None else torch.from_numpy(rs),
                               same_length)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    jreset = None if rs is None else jnp.asarray(rs)

    def f_fused(w, k_mem, v_mem, qkv_w, r_w, r_w_bias, r_r_bias):
        return fused_j(w, k_mem, v_mem, j["r"], qkv_w, r_w, r_w_bias,
                       r_r_bias, jnp.int32(count), jreset, H, DH,
                       same_length=same_length)

    jouts, vjp = jax.vjp(f_fused, *(j[k] for k in GRAD_KEYS))
    _close(outs, jouts)
    ref = vjp(tuple(jnp.asarray(c) for c in cot))
    _close([grads[k] for k in GRAD_KEYS], ref)

    mask = jxl.build_attn_mask(qlen, mem, jnp.int32(count), jreset,
                               same_length, bsz)

    def f_jnp(w, k_mem, v_mem, qkv_w, r_w, r_w_bias, r_r_bias):
        return jatt.rel_attention_kv(w, k_mem, v_mem, j["r"], qkv_w, r_w,
                                     r_w_bias, r_r_bias, mask, H, DH)

    _, vjp2 = jax.vjp(f_jnp, *(j[k] for k in GRAD_KEYS))
    ref2 = vjp2(tuple(jnp.asarray(c) for c in cot))
    skip = ("k_mem", "v_mem") if variant == "v2" else ()
    _close([grads[k] for k in GRAD_KEYS if k not in skip],
           [r for k, r in zip(GRAD_KEYS, ref2) if k not in skip])
    if variant == "v2":
        assert not grads["k_mem"].any() and not grads["v_mem"].any()


# ---------------------------------------------------------------------------
# gradcheck (fp64) and dropout
# ---------------------------------------------------------------------------

def _f64(rng, *shape):
    return torch.from_numpy(rng.randn(*shape) * 0.5)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_gradcheck_xl_attn_v2(rate):
    """fp64 gradcheck of XLAttnV2 (K1f / K1b plain versions); at rate 0.3
    the backward must redraw the forward's mask from the same seed."""
    rng = np.random.RandomState(1)
    Hh, B, q, M, dh = 1, 2, 4, 3, 3
    qrw, qrr, kc, vc = (_f64(rng, Hh, B, q, dh).requires_grad_()
                        for _ in range(4))
    km, vm = _f64(rng, Hh, B, M, dh), _f64(rng, Hh, B, M, dh)
    rk = _f64(rng, Hh, M + 2 * q, dh)
    rk[:, M + q:] = 0.0
    rk.requires_grad_()
    reset = torch.tensor([0, 1])

    def f(qrw, qrr, kc, vc, rk):
        return tops.XLAttnV2.apply(qrw, qrr, km, vm, kc, vc, rk, 2, reset,
                                   123, rate, False)

    assert torch.autograd.gradcheck(f, (qrw, qrr, kc, vc, rk))


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_gradcheck_xl_attn_v1(rate):
    rng = np.random.RandomState(2)
    BH, q, M, dh = 2, 4, 3, 3
    qq, k, v, bd = (_f64(rng, *s).requires_grad_() for s in
                    ((BH, q, dh), (BH, M + q, dh), (BH, M + q, dh),
                     (BH, q, M + q)))

    def f(qq, k, v, bd):
        return tops.XLAttnV1.apply(qq, k, v, bd, 2, torch.tensor([1, 0]),
                                   0.7, True, 99, rate)

    assert torch.autograd.gradcheck(f, (qq, k, v, bd))


def test_dropout_keep_rate_within_4_sigma():
    n_bh, q, klen = 10, 128, 1152
    for rate in (0.1, 0.5):
        keep = tops.keep_mask(5, n_bh, q, klen, rate)
        n = keep.numel()
        sigma = (rate * (1 - rate) / n) ** 0.5
        assert abs(float(keep.float().mean()) - (1 - rate)) < 4 * sigma
        # each row and block is unbiased too (no structure along one axis)
        per_bh = keep.float().mean(dim=(1, 2))
        sigma_bh = (rate * (1 - rate) / (q * klen)) ** 0.5
        assert float((per_bh - (1 - rate)).abs().max()) < 5 * sigma_bh


def test_dropout_mask_independent_of_grid_order():
    """The mask is a function of (seed, bh, i, j) alone: any order or tiling
    of the grid redraws the same bits; another seed gives another mask."""
    full = tops.keep_mask(11, 6, 16, 40, 0.3)
    perm = torch.randperm(16 * 40, generator=torch.Generator().manual_seed(0))
    i, j = perm // 40, perm % 40
    for bh in range(6):
        bits = tops.dropout_bits(11, torch.tensor(bh), i, j)
        assert torch.equal(bits >= tops.dropout_threshold(0.3), full[bh, i, j])
    assert not torch.equal(full, tops.keep_mask(12, 6, 16, 40, 0.3))


def test_rate_zero_equals_no_dropout():
    rng = np.random.RandomState(3)
    t = [torch.from_numpy(x) for x in (
        _a(rng, H, 2, 16, DH), _a(rng, H, 2, 16, DH), _a(rng, H, 2, 12, DH),
        _a(rng, H, 2, 12, DH), _a(rng, H, 2, 16, DH), _a(rng, H, 2, 16, DH),
        _a(rng, H, 12 + 32, DH))]
    base = tops.xl_attn_fwd_v2(*t, 5, None, False)
    zero = tops.xl_attn_fwd_v2(*t, 5, None, False, seed=77, rate=0.0)
    for a, b in zip(base, zero):
        assert torch.equal(a, b)
    x = _contract_inputs(16, 2, 12, seed=4)
    tt = {k: torch.from_numpy(v) for k, v in x.items()}
    args = (tt["w"], tt["k_mem"], tt["v_mem"], tt["r"], tt["qkv_w"],
            tt["r_w"], tt["r_w_bias"], tt["r_r_bias"], 5, None, H, DH)
    for fused in (tops.rel_attention_kv_fused_v2, tops.rel_attention_kv_fused):
        a = fused(*args, same_length=False)
        b = fused(*args, same_length=False, dropatt=0.1)  # no seed: off
        c = fused(*args, same_length=False, dropatt=0.1, seed=3)
        assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])


def test_plain_attention_dropout_keeps_rate():
    """The plain path's dropout (an explicit generator's uniform draws)
    keeps 1 - rate of the probabilities and rescales them."""
    x = _contract_inputs(16, 2, 12, seed=5)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    mask = tatt.build_attn_mask(16, 12, 12, False)
    args = (t["w"], t["k_mem"], t["v_mem"], t["r"], t["qkv_w"], t["r_w"],
            t["r_w_bias"], t["r_r_bias"], mask, H, DH)
    base = tatt.rel_attention_kv(*args)[0]
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    d1 = tatt.rel_attention_kv(*args, dropatt=0.2, generator=g1)[0]
    d2 = tatt.rel_attention_kv(*args, dropatt=0.2, generator=g2)[0]
    assert torch.equal(d1, d2) and not torch.allclose(d1, base)
    assert torch.equal(tatt.rel_attention_kv(*args, dropatt=0.2)[0], base)
